"""Shape-bucket policy: which padded shapes get compiled, and how requests
map onto them.

XLA compiles one executable per input shape; serving arbitrary batch sizes /
sequence lengths would recompile constantly.  The policy quantizes dynamic
dimensions to a small set of buckets (compile once per bucket, pad to fit).
This is the TPU-native replacement for the reference batcher's single
max-batch knob (reference pkg/batcher/handler.go:32-36) — bucket boundaries
ARE the jit compile shapes (SURVEY.md §7 "hard parts").
"""

import bisect
from typing import List, Optional, Sequence


def pow2_buckets(max_value: int, min_value: int = 1) -> List[int]:
    out = []
    v = min_value
    while v < max_value:
        out.append(v)
        v *= 2
    out.append(max_value)
    return out


class BucketPolicy:
    """Quantize a dynamic dimension (batch or sequence length) to buckets."""

    def __init__(self, buckets: Sequence[int]):
        if not buckets:
            raise ValueError("buckets must be non-empty")
        self.buckets = sorted(set(int(b) for b in buckets))

    @classmethod
    def pow2(cls, max_value: int, min_value: int = 1) -> "BucketPolicy":
        return cls(pow2_buckets(max_value, min_value))

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def fit(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None if n exceeds the largest bucket."""
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            return None
        return self.buckets[i]

    def floor_fit(self, n: int) -> Optional[int]:
        """Largest bucket <= n, or None if n is below the smallest bucket.
        The batcher's bucket-aligned flush uses this: executing exactly a
        bucket's worth of pending instances pads zero slots."""
        i = bisect.bisect_right(self.buckets, n) - 1
        if i < 0:
            return None
        return self.buckets[i]

    def waste(self, n: int) -> float:
        """Fraction of padded work wasted for a size-n batch."""
        b = self.fit(n)
        if b is None:
            return 0.0
        return (b - n) / b
