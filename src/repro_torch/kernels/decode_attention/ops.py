"""Single-token decode attention in the model layout: the kernel for CUDA
tensors, the plain version (through the kernel layout, as the JAX
package's ``ops`` calls its Pallas kernel) for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import \
    decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Optional[int] = None, *,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, Smax, K, hd) (any strides with the head
    dim contiguous).  Either ``pos``, the position just written (every row
    valid through it), or ``lengths`` (B*K,) int32, the valid length of
    each (batch, KV head) row as the TPU kernel takes them.  Returns
    (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    if (pos is None) == (lengths is None):
        raise ValueError("give exactly one of pos and lengths")
    if lengths is None:
        lengths = torch.full((B * K,), int(pos) + 1, dtype=torch.int32,
                             device=q.device)
    if q.device.type != "cpu":
        return decode_attention_kernel(q[:, 0], k_cache, v_cache,
                                       lengths).reshape(B, 1, H, hd)
    G = H // K
    qf = q.reshape(B * K, G, hd)
    kf = k_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    vf = v_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    return decode_attention_ref(qf, kf, vf, lengths).reshape(B, 1, H, hd)
