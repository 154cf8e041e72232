"""Multi-device execution: a (dp, sp) mesh of devices, batch and row
sharding with halo rows."""
