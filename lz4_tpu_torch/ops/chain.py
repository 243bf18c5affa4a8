"""X3: the orbit of index 0 under a strictly increasing successor, by
binary lifting, row by row.

The port of `lz4_tpu/ops/chain.py` `materialize_chain`, shared by the dense
codecs (`decode_dense.py`: the token chain; `encode_dense.py`: the anchor
chain).  Jump tables d_k = d_{k-1} o d_{k-1} are built by gathers only, and
P[2^k : 2^(k+1)] = d_k[P[0 : 2^k]]: the orbit comes out in ascending order,
with no reachability mask and no compaction.  PyTorch tensor ops: the same
code runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

from .common import ceil_log2, gather


def materialize_chain(nxt: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Orbit of index 0 under ``nxt`` in each row.

    nxt: int32 [B, m], strictly increasing (nxt[b, i] > i) except a
    self-loop at the terminal "dead" index m - 1.  Returns P: int32
    [B, cap], cap = max_steps rounded up to a power of two, with P[b, s] the
    position after s steps (it sticks at the dead index once reached).
    Counted in ``materialize_chain.launches``, once a call."""
    materialize_chain.launches += 1
    rows, m = nxt.shape
    k_max = ceil_log2(max_steps)
    cap = 1 << k_max
    p = torch.full((rows, cap), m - 1, dtype=torch.int32, device=nxt.device)
    p[:, 0] = 0
    d = nxt
    size = 1
    for _ in range(k_max):
        p[:, size:2 * size] = gather(d, p[:, :size])
        size *= 2
        if size < cap:
            d = gather(d, d)
    return p


materialize_chain.launches = 0
