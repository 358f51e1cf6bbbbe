"""Plain PyTorch versions of the SSD chunk scan: the sequential oracle (the
twin of the JAX package's ``ssd_scan_ref``) and the chunked algorithm of
its Mamba2 model (``ssd_chunked``), which also returns the final state.

Shapes: x (B, S, H, P) values; dt (B, S, H) float32, > 0; A (H,) float32,
< 0; Bm / Cm (B, S, N), one group shared by every head.  Arithmetic in
float32; y in x's dtype."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t, one
    position at a time."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                                   # (B, H)
        decay = torch.exp(dtt * A[None, :])
        upd = torch.einsum("bn,bhp->bhnp", Bm[:, t].float(),
                           x[:, t].float() * dtt[..., None])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan: an intra-chunk masked product (quadratic in the
    chunk length only) and an (N, P) state carried over the chunks.  A tail
    shorter than ``chunk`` is zero-padded: dt = 0 there, so the padded
    positions add nothing and the state stays as the last real position
    left it.  Returns (y (B, S, H, P), final state (B, H, N, P) float32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        pad = chunk - S % chunk

        def pad2(t):
            return torch.cat([t, t.new_zeros((t.shape[0], pad,
                                              *t.shape[2:]))], dim=1)

        y, final = ssd_chunked(pad2(x), pad2(dt), A, pad2(Bm), pad2(Cm),
                               chunk, init_state)
        return y[:, :S], final
    nc, L = S // chunk, chunk
    f32 = torch.float32
    dA = dt * A[None, None, :]                                   # (B,S,H)
    xw = x * dt[..., None]                          # dt-weighted, float32

    def r(t):
        return t.reshape(Bsz, nc, L, *t.shape[2:])

    dA_c, xw_c, B_c, C_c = r(dA), r(xw), r(Bm).to(f32), r(Cm).to(f32)
    cum = torch.cumsum(dA_c, dim=2)                              # (B,nc,L,H)
    seg_sum = cum[:, :, -1:, :]

    # intra-chunk: decay(l, s) = exp(cum[l] - cum[s]) for s <= l
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,L,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                        torch.zeros((), dtype=f32, device=x.device))
    cb = torch.einsum("bcln,bcsn->bcls", C_c, B_c)
    M = cb[..., None] * decay
    y_intra = torch.einsum("bclsh,bcshp->bclhp", M, xw_c.to(f32))

    # each chunk's own state contribution
    decay_to_end = torch.exp(seg_sum - cum)                      # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchnp", B_c, decay_to_end,
                          xw_c.to(f32))                          # (B,nc,H,N,P)

    # the recurrence over chunks
    prev = (torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
            if init_state is None else init_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * torch.exp(seg_sum[:, c, 0])[:, :, None, None] \
            + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                      # (B,nc,H,N,P)

    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", C_c, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), prev
