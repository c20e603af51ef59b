"""Speculative decoding support: draft proposers and the draft model's
residency handle.

Port of ``kfserving_tpu/engine/speculative.py``.  Decode is bound by the
bytes it reads: every wave reads the whole parameter set to emit one
token a slot.  Speculative decoding spreads that read over K + 1 tokens:
a cheap proposer guesses K tokens a live slot, the target scores all
K + 1 positions in one Lq = K + 1 dispatch (the paged cache's
multi-token mode with multi-position ``logit_positions``,
``engine/generator.py``), and the engine accepts the longest prefix on
which the target's own sampled token equals the proposal.

Two proposers, one contract (K tokens a slot):

- ``NGramProposer``: the prompt-lookup head, on the host (a copy of the
  JAX package's, numpy and lists only): find the longest n-gram suffix
  of the slot's history earlier in its stream and replay the tokens
  that followed it.
- ``make_draft_proposer``: a small decoder proposing greedily over a
  rolling window of the history, K cache-less forwards (causal
  attention over the window: the flash kernel on the card), each
  argmaxing the last position and rolling it in.  The window rides
  relative positions 0..W-1, as the JAX proposer's does: proposals are
  guesses, the verify dispatch decides.

Acceptance is exact.  The sampler is deterministic given (seed, absolute
position), so the target's draw at a position is a function of the
prefix, and accepting a proposal only where it equals that draw gives
the tokens of non-speculative decode, greedy and seeded alike.

``DraftModel`` is the residency manager's handle for the draft: it
registers beside the target so the ledger and the model list show it,
and it is pinned (``offloadable`` False) while the target serves.
"""

import logging
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

logger = logging.getLogger("kfserving_tpu_torch.speculative")

# Longest n-gram the prompt-lookup head tries to match, descending to 1.
NGRAM_MAX_N = 3
# Rolling draft window default.
DEFAULT_DRAFT_WINDOW = 32


class NGramProposer:
    """Prompt-lookup proposer: propose the K tokens that followed the
    most recent earlier occurrence of the history's longest suffix
    n-gram.  Host-side only: no device work, no device memory."""

    def __init__(self, k: int, max_n: int = NGRAM_MAX_N):
        self.k = int(k)
        self.max_n = int(max_n)

    def propose(self, history: Sequence[int]) -> List[int]:
        """K proposed continuation tokens for one slot.  A history with
        no repeated suffix proposes repeats of the last token."""
        hist = list(history)
        k = self.k
        n_hist = len(hist)
        fill = hist[-1] if hist else 0
        for n in range(min(self.max_n, n_hist - 1), 0, -1):
            key = hist[-n:]
            # The most recent earlier occurrence wins.
            for start in range(n_hist - n - 1, -1, -1):
                if hist[start:start + n] == key:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return (cont + [fill] * k)[:k]
        return [fill] * k


def rolling_windows(histories: Sequence[Sequence[int]], slots: int,
                    rows: Sequence[int], window: int) -> np.ndarray:
    """[slots, window] int32 draft-model input: each listed row's last
    ``window`` history tokens, left-padded with 0.  Unlisted rows stay
    zero; their proposals are garbage the verify dispatch parks."""
    ids = np.zeros((slots, window), np.int32)
    for row, hist in zip(rows, histories):
        tail = list(hist)[-window:]
        if tail:
            ids[row, window - len(tail):] = tail
    return ids


def make_draft_proposer(module: torch.nn.Module, slots: int, window: int,
                        k: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Greedy rolling-window proposer: ``ids`` [slots, window] (int) ->
    proposals [slots, k] int32.  Each of the k steps runs one cache-less
    causal forward over the window, argmaxes its last position (first
    index on ties, as ``jnp.argmax``) and rolls the token in: static
    shapes, so on the card the whole proposal is one CUDA graph per
    (slots, window, k).  Greedy whatever the request samples with."""
    def propose(ids: torch.Tensor) -> torch.Tensor:
        last = torch.full((slots,), window - 1, dtype=torch.int32,
                          device=ids.device)
        toks = []
        for _ in range(k):
            logits = module(ids, logit_positions=last)
            nxt = logits[:, 0].argmax(dim=-1).to(torch.int32)
            ids = torch.cat([ids[:, 1:], nxt[:, None].to(ids.dtype)], dim=1)
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    return propose


class DraftModel:
    """Residency-manager handle for the draft (the managed-model
    contract of ``engine/residency.py``).  The draft depends on a live
    target engine: it registers as resident (ready, engine set), reports
    its parameter bytes for the ledger, and vetoes eviction while the
    target serves."""

    def __init__(self, name: str, module: torch.nn.Module,
                 target_engine: Any, window: int = DEFAULT_DRAFT_WINDOW):
        self.name = name
        self.module = module
        self.window = int(window)
        self.engine = target_engine
        self.ready = True

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.module.parameters())

    # -- residency hooks ---------------------------------------------------
    @property
    def offloadable(self) -> bool:
        """Pinned while the target engine is live: evicting the draft
        would move every stream in flight to non-speculative decode."""
        return self.engine is None

    def offload(self) -> None:
        raise RuntimeError(
            f"draft model {self.name} is pinned while its target "
            "engine serves")

    def fault_in(self) -> None:
        """Nothing to restore: the draft's parameters live where the
        target's load placed them."""

    def host_bytes(self) -> int:
        return self.param_bytes()

    def load(self) -> None:
        """The target's load builds the draft; a standalone load does
        nothing."""

    def release(self) -> None:
        """Unpin on target unload: the handle stops claiming an engine,
        so a registration that outlives the target vetoes nothing."""
        self.engine = None
