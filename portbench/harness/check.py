"""The comparison that decides `correct`.

Each sampled answer is held against the plain reference
(`reference/filters.py`) computed again from the benchmark's own inputs.
The configuration states which answers are exact and which are held to a
tolerance (`numerics` in its file), and so fixes every limit:

* `exact_bytes_off`: bytes of the exact answers that differ from the
  reference, limit 0;
* `near_bytes_beyond_tol`: bytes of the other answers that differ by more
  than the stated tolerance (1 for the level-4 gaussian, 6 for a colour
  Sobel), limit 0;
* `near_worst_share_pct`: the largest share of one such answer's bytes
  that differ at all, limit the stated share (0.1%);
* `decode_bytes_beyond_tol`: where the upload was a JPEG, bytes of the
  server's decode of it (the reply's original) that differ from the
  reference decode (`reference/jpeg.py`) by more than the stated
  tolerance (`within_tolerance.jpeg_decode`), limit 0;
* `decode_worst_share_pct`: the largest share of one such decode's bytes
  that differ at all, limit the stated share;
* `unreadable_answers`: sampled answers that could not be read (a reply
  that is not 200, a PNG this reader refuses, a wrong shape, a JPEG's
  original passed back unchanged), limit 0.

A near number is printed only where the sample holds a near answer, a
decode number only where it holds a JPEG upload.  The decode numbers are
kept apart from the near ones: their share limit is the decode's own, not
a minimum over the filters' answers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


def tolerance(numerics: dict, filter_name: str, level: int,
              channels: int) -> dict | None:
    """The stated tolerance of one answer, or None where it is exact."""
    tol = numerics["within_tolerance"]
    if filter_name == "gaussian" and level == 4:
        return tol["gaussian_level_4"]
    if filter_name == "sobel" and channels > 1:
        return tol["sobel_colour"]
    return None


@dataclass
class Comparison:
    """The compared numbers over the answers `add`ed so far."""

    numerics: dict
    answers: int = 0
    exact_bytes_off: int = 0
    near_answers: int = 0
    near_bytes_beyond_tol: int = 0
    near_worst_share_pct: float = 0.0
    near_share_limit_pct: float = float("inf")
    decode_answers: int = 0
    decode_bytes_beyond_tol: int = 0
    decode_worst_share_pct: float = 0.0
    unreadable_answers: int = 0
    notes: list[str] = field(default_factory=list)

    def unreadable(self, why: str) -> None:
        self.answers += 1
        self.unreadable_answers += 1
        if len(self.notes) < 5:
            self.notes.append(why)

    def add(self, got: torch.Tensor, want: torch.Tensor, filter_name: str,
            level: int) -> None:
        """Hold answer `got` against `want`, both (..., H, W, C) uint8."""
        if got.shape[-1] == 1 and want.shape[-1] > 1:
            got = got.expand(want.shape)   # a grey PNG of a Sobel answer
        if tuple(got.shape) != tuple(want.shape):
            self.unreadable(f"{filter_name} L{level}: shape "
                            f"{tuple(got.shape)}, expected {tuple(want.shape)}")
            return
        self.answers += 1
        diff = (got.to(want.device).to(torch.int16)
                - want.to(torch.int16)).abs()
        tol = tolerance(self.numerics, filter_name, level, want.shape[-1])
        if tol is None:
            self.exact_bytes_off += int((diff > 0).sum())
            return
        self.near_answers += 1
        self.near_bytes_beyond_tol += int((diff > tol["max_diff"]).sum())
        share = 100.0 * float((diff > 0).sum()) / diff.numel()
        self.near_worst_share_pct = max(self.near_worst_share_pct, share)
        self.near_share_limit_pct = min(self.near_share_limit_pct,
                                        tol["max_share_pct"])

    def add_decode(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """Hold a server's decode `got` of a JPEG upload against the
        reference decode `want`, both (H, W, 3) uint8."""
        if tuple(got.shape) != tuple(want.shape):
            self.unreadable(f"decode: shape {tuple(got.shape)}, expected "
                            f"{tuple(want.shape)}")
            return
        self.answers += 1
        self.decode_answers += 1
        tol = self.numerics["within_tolerance"]["jpeg_decode"]
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        self.decode_bytes_beyond_tol += int((diff > tol["max_diff"]).sum())
        share = 100.0 * float((diff > 0).sum()) / diff.numel()
        self.decode_worst_share_pct = max(self.decode_worst_share_pct, share)

    def numbers(self) -> dict[str, dict]:
        """Each compared number with its limit, in print order."""
        out = {"exact_bytes_off": {"value": self.exact_bytes_off, "limit": 0}}
        if self.near_answers:
            out["near_bytes_beyond_tol"] = {
                "value": self.near_bytes_beyond_tol, "limit": 0}
            out["near_worst_share_pct"] = {
                "value": self.near_worst_share_pct,
                "limit": self.near_share_limit_pct}
        if self.decode_answers:
            tol = self.numerics["within_tolerance"]["jpeg_decode"]
            out["decode_bytes_beyond_tol"] = {
                "value": self.decode_bytes_beyond_tol, "limit": 0}
            out["decode_worst_share_pct"] = {
                "value": self.decode_worst_share_pct,
                "limit": tol["max_share_pct"]}
        out["unreadable_answers"] = {"value": self.unreadable_answers,
                                     "limit": 0}
        return out

    @property
    def correct(self) -> bool:
        return self.answers > 0 and all(
            n["value"] <= n["limit"] for n in self.numbers().values())
