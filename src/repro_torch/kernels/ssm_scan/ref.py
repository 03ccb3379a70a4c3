"""Sequential oracle for the selective-scan kernel.

The counterpart of the reference's ``kernels/ssm_scan/ref.py``: an f32 loop
over time, the output cast to the input dtype."""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, u, b_t, c_t, a):
    """dt/u: (B, S, di); b_t/c_t: (B, S, N); a: (di, N) -> y (B, S, di)."""
    dtf, uf = dt.float(), u.float()
    bf, cf, af = b_t.float(), c_t.float(), a.float()
    b, s, di = dt.shape
    h = torch.zeros((b, di, af.shape[1]), dtype=torch.float32, device=dt.device)
    y = torch.empty((b, s, di), dtype=torch.float32, device=dt.device)
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af[None])  # (B, di, N)
        h = da * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t])
    return y.to(dt.dtype)
