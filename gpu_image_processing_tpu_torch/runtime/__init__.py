"""Device selection, kernel timing and the filter runtime."""
