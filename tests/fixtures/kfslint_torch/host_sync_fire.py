"""kfslint golden fixture (port): host-sync MUST fire on every marked
line (never executed, only parsed)."""
import numpy as np
import torch


async def decode_step(module, feed):
    toks = torch.argmax(feed, -1)
    first = float(toks[0])           # FIRE: float() joins the stream
    count = int(torch.sum(toks))     # FIRE: int() on an inline op
    host = np.asarray(toks)          # FIRE: np.asarray fetch
    listed = toks.tolist()           # FIRE: .tolist() fetch
    one = toks[0].item()             # FIRE: .item() fetch
    logits = module(feed)
    back = logits.cpu()              # FIRE: .cpu() of a forward
    return first, count, host, listed, one, back


def fetch_wave(toks_h, lp_h, event):
    # The *_h naming convention marks device handles crossing helpers.
    tokens = toks_h.numpy()          # FIRE: handle fetch in a wave fn
    lp = tuple(np.asarray(h) for h in lp_h)  # FIRE: comprehension fetch
    event.synchronize()              # FIRE: an event wait
    torch.cuda.synchronize()         # FIRE: a device-wide wait
    return tokens, lp


def prefill_program(graph, out):
    graph.replay()
    return bool(graph.replay())      # FIRE: bool() of a replay
