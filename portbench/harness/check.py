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
* `unreadable_answers`: sampled answers that could not be read (a reply
  that is not 200, a PNG this reader refuses, a wrong shape), limit 0.

A near number is printed only where the sample holds a near answer.
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

    def numbers(self) -> dict[str, dict]:
        """Each compared number with its limit, in print order."""
        out = {"exact_bytes_off": {"value": self.exact_bytes_off, "limit": 0}}
        if self.near_answers:
            out["near_bytes_beyond_tol"] = {
                "value": self.near_bytes_beyond_tol, "limit": 0}
            out["near_worst_share_pct"] = {
                "value": self.near_worst_share_pct,
                "limit": self.near_share_limit_pct}
        out["unreadable_answers"] = {"value": self.unreadable_answers,
                                     "limit": 0}
        return out

    @property
    def correct(self) -> bool:
        return self.answers > 0 and all(
            n["value"] <= n["limit"] for n in self.numbers().values())
