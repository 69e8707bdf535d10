"""Plain float32 building blocks of the references, and the weights they
read.

Nothing here imports the program: each block is written from the
published equations (and from the departures each configuration's file
lists under ``assumed``), in straightforward PyTorch, float32 throughout
with TF32 off.  The SSD block is its quadratic (attention-like) dual form,
``y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s``, not
the chunked scan the program runs, so a fault in the program's chunking
or in its inter-chunk recurrence cannot hide in a shared formula.

``fp8=True`` is the control: every product with a weight takes its
operands rounded to float8 e4m3 (activations per token, weights per
output column, each scaled by its largest magnitude), as an fp8 serving
path would; the products of activations with activations (the SSD's) stay
float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

F32 = torch.float32
FP8_MAX = 448.0          # the largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool = False
           ) -> torch.Tensor:
    """x (..., K) @ w (K, N), float32 (or fp8-rounded operands)."""
    if fp8:
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) * (1 + gamma)."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + gamma)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution over time, then silu.  x (R, T, C),
    w (K, C): ``y_t = silu(b + sum_i w_i x_{t-K+1+i})``, zeros before t=0."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    return silu(b + sum(w[i] * xp[:, i:i + t] for i in range(k)))


def ssd_quadratic(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, block: int = 128
                  ) -> torch.Tensor:
    """The SSD recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t``,
    ``y_t = h_t . C_t``, from a zero state, in its quadratic form, taken
    ``block`` outputs at a time.  x (R, T, H, P) is already multiplied by
    dt; dt (R, T, H); a (H,) < 0; b, c (R, T, N).  The decays' cumulative
    sums are taken in float64 and, for each block, measured from the
    block's first step before they are rounded to float32, so that a
    decay between nearby steps keeps its precision however long the
    sequence."""
    r, t, h, p = x.shape
    cum = torch.cumsum((dt * a).to(torch.float64), dim=1)      # (R, T, H)
    steps = torch.arange(t, device=x.device)
    y = torch.empty_like(x)
    for i in range(r):
        for t0 in range(0, t, block):
            t1 = min(t, t0 + block)
            anchor = cum[i, t0]
            ct = (cum[i, t0:t1] - anchor).to(F32).T               # (H, b)
            cs = (cum[i, :t1] - anchor).to(F32).T                 # (H, t1)
            seg = ct[:, :, None] - cs[:, None, :]                 # (H, b, t1)
            later = steps[None, :t1] > steps[t0:t1, None]
            lmat = torch.exp(seg.masked_fill_(later, -math.inf))
            g = c[i, t0:t1] @ b[i, :t1].T                         # (b, t1)
            y[i, t0:t1] = ((lmat * g) @ x[i, :t1].transpose(0, 1)
                           ).transpose(0, 1)
    return y


def ssm_branch(w: Dict[str, torch.Tensor], h: torch.Tensor, heads: int,
               headdim: int, eps: float, fp8: bool) -> torch.Tensor:
    """The Mamba-2 block on its normed input h (R, T, D): projections,
    causal convolutions of x, B and C, the SSD with the D skip (on the
    dt-scaled x), the silu(z) gate, the gated RMSNorm and out_proj."""
    z = linear(h, w["z_proj"], fp8)
    xs = causal_conv(linear(h, w["x_proj"], fp8), w["conv_x_w"],
                     w["conv_x_b"])
    bb = causal_conv(linear(h, w["b_proj"], fp8), w["conv_b_w"],
                     w["conv_b_b"])
    cc = causal_conv(linear(h, w["c_proj"], fp8), w["conv_c_w"],
                     w["conv_c_b"])
    dt = softplus(linear(h, w["dt_proj"], fp8) + w["dt_bias"])  # (R, T, H)
    a = -torch.exp(w["a_log"])
    r, t, _ = h.shape
    xh = xs.reshape(r, t, heads, headdim) * dt[..., None]
    y = ssd_quadratic(xh, dt, a, bb, cc) + w["d_skip"][:, None] * xh
    y = y.reshape(r, t, heads * headdim) * silu(z)
    return linear(rms_norm(y, w["norm"], eps), w["out_proj"], fp8)


def embed(w: torch.Tensor, tokens: torch.Tensor, fp8: bool) -> torch.Tensor:
    rows = w[tokens]
    return fp8_round(rows, -1) if fp8 else rows


def layer_weights(weights: Dict[str, torch.Tensor], i: int, prefix: str
                  ) -> Dict[str, torch.Tensor]:
    """Layer i's slice of every stacked leaf under ``prefix``."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in weights.items() if k.startswith(prefix)}


# ------------------------------------------------------------- weights

def leaf(path: str, shape: Tuple[int, ...], init: str, fan_in: int = 1):
    """One weight: its leaf path (the program's parameter tree), shape
    and how it is drawn from a standard normal n (``draw``)."""
    return (path, tuple(shape), init, fan_in)


def _phi(n: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1 + torch.erf(n / math.sqrt(2)))


def _shape(n: torch.Tensor, init: str, fan_in: int) -> torch.Tensor:
    """A standard normal draw made into a weight of kind ``init``."""
    if init == "normal":          # a projection: 1 / sqrt(its fan-in)
        return n.mul_(1 / math.sqrt(fan_in))
    if init in ("norm", "bias"):  # small, so every gain and bias matters
        return n.mul_(0.1)
    if init == "embed":
        return n
    if init == "a_log":           # A = -exp(a_log) in [-16, -1]
        return torch.log1p(15 * _phi(n))
    if init == "dt_bias":         # softplus(dt_bias) in [1e-3, 1e-1]
        dt = torch.exp(math.log(1e-3) + _phi(n) * math.log(100.0))
        return dt + torch.log(-torch.expm1(-dt))
    if init == "d_skip":
        return n.mul_(0.1).add_(1.0)
    raise ValueError(init)


def draw(leaves: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight in float32 on ``device`` from ``seed``: one standard
    normal draw over all of them on the device's own generator, then one
    in-place transform a leaf.  Returns {path: tensor}, each a
    contiguous view of the one buffer."""
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=F32)
    out, off = {}, 0
    for path, shape, init, fan_in in leaves:
        n = math.prod(shape)
        view = flat[off:off + n]
        new = _shape(view, init, fan_in)
        if new.data_ptr() != view.data_ptr():
            view.copy_(new)
        out[path] = view.view(shape)
        off += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}: the program's parameter tree."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
