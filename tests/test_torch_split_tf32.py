"""The error of the split-TF32 products of the f32 encoder attention kernels
on the tensor cores (``csrc/attention_tf32.cuh``: the windowed body of K2 /
K7; ``csrc/attention_relpos_wgmma_tf32.cu``: K1 and K6 on wgmma;
``csrc/attention_bwd_wgmma_tf32.cu``: K5's backward on wgmma), emulated on
the CPU.

A kernel on mma.sync splits each f32 operand x as hi = tf32(x) (rounded as
``cvt.rna.tf32.f32`` rounds: to nearest on the 13 low mantissa bits, ties
away from zero; the kernels add half a TF32 ulp to the bits and clear the 13
low ones, as ``tf32_rna`` below) and lo = x - hi, whose top 19 bits the
tensor cores read (truncation, emulated as such), and takes a product a.b as
lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 accumulation. The wgmma kernels of
K1 / K6 and K5 split by truncation (``split_trunc``): the raw f32 is its own hi,
since the tensor cores read its top 19 bits, and lo = x - trunc(x). Products
of TF32 values are exact in f32, so an f32 matmul of the split operands on
the CPU emulates the tensor cores up to the order of the f32 sums.

Each test holds the emulated kernel arithmetic against the port's plain f32
version on the same inputs (numpy-seeded, as the card tests make them):
every output within ``SPLIT_TOL`` of max |plain|, ten times under the
card's f32 limit (``chip_smoke.py``'s ``K34_TOL['f32']`` = 1e-4 for K5;
``F32_ATOL`` = 1e-4 for the forward), and at least ten times closer than
single TF32 (hi.hi alone), so the test tells the two apart. What it does
not model is the tensor cores' own f32 accumulation, which the card adds
and which grows with the number of k steps summed into one accumulator
(the card's K5 error at a 4096-key layer, ``chip_smoke.py``, is above this
test's bound though within the card's). Runs without a card."""

import functools

import numpy as np
import pytest
import torch

from dilabhelmholtzoct_tpu_torch import kernels
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as port_i2t
from dilabhelmholtzoct_tpu_torch.ops import upscaler as port_up

SPLIT_TOL = 1e-5  # of max |plain|, per output
GAIN_MIN = 10.0   # single-TF32 error / split-TF32 error, per output


def tf32_rna(x):
    """x rounded to TF32 as cvt.rna does it: to nearest on the 13 low
    mantissa bits, ties away from zero (adding half a TF32 ulp to the
    sign-magnitude bits, then clearing them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """The top 19 bits of x, as the tensor cores read a .tf32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_split(a, b):
    """a @ b in split TF32: the small terms first, f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_single(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def split_trunc(x):
    """The wgmma kernels' split: hi = trunc(x) (the raw f32 as the tensor
    cores read it), lo = x - hi (exact in f32) as they read it."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def mm_split_trunc(a, b):
    """a @ b in split TF32 with the truncation split: the small terms
    first, f32 sums."""
    ah, al = split_trunc(a)
    bh, bl = split_trunc(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_single_trunc(a, b):
    """What the tensor cores make of raw f32 operands: one TF32 product."""
    return tf32_trunc(a) @ tf32_trunc(b)


def _inputs(b, nh, hw, seed=0, d=64):
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    arrays = (rng.normal(size=(b, n, 3 * nh * d)) * 0.5,
              rng.normal(size=(b, nh, n, hw[0])) * 0.3,
              rng.normal(size=(b, nh, n, hw[1])) * 0.3,
              rng.normal(size=(b, n, nh * d)))
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _heads(x, nh):
    b, n, c = x.shape
    return x.view(b, n, nh, c // nh).transpose(1, 2)


def _merge(x):
    b, nh, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, nh * d)


def _bias(rel_h, rel_w):
    b, nh, n, h = rel_h.shape
    w = rel_w.shape[-1]
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, n, h * w)


def emulated_bwd(qkv, rel_h, rel_w, g, lse, dvec, nh, mm):
    """K5's arithmetic with every product through ``mm``: p and ds in f32,
    never rounded; dq and dk take the 1/8 after the sums (exact)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    go = _heads(g, nh)
    s = mm(q, k.transpose(-1, -2)) * 0.125 + _bias(rel_h, rel_w)
    p = torch.exp(s - lse[..., None])
    del s
    ds = p * (mm(go, v.transpose(-1, -2)) - dvec[..., None])
    dv = mm(p.transpose(-1, -2), go)
    del p
    dq = mm(ds, k) * 0.125
    dk = mm(ds.transpose(-1, -2), q) * 0.125
    b, _, n, h = rel_h.shape
    w = rel_w.shape[-1]
    grid = ds.reshape(b, nh, n, h, w)
    drel_h, drel_w = grid.sum(-1), grid.sum(-2)
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    return dqkv, drel_h, drel_w


def emulated_windowed_fwd(qkv, rel_h, rel_w, nh, mm):
    """The windowed body's arithmetic: q.k^T / 8 (the scale on q, exact)
    through ``mm``, then the bias as the product of the rows' factors F =
    [rel_h | rel_w] with the exact one-hot E (F split into hi and lo, two
    products, or hi alone), the softmax in f32, p.v through ``mm`` and o / l
    last. Returns (out, lse)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    b, _, n, h = rel_h.shape
    w = rel_w.shape[-1]
    keys = torch.arange(n)
    onehot = torch.zeros(h + w, n)
    onehot[keys // w, keys] = 1.0
    onehot[h + keys % w, keys] = 1.0
    factors = torch.cat([rel_h, rel_w], dim=-1)
    fh, fl = split(factors)
    bias = fh @ onehot + fl @ onehot if mm is mm_split else fh @ onehot
    s = mm(q * 0.125, k.transpose(-1, -2)) + bias
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, v) / l
    return _merge(out), (m + torch.log(l))[..., 0]


def _errors(got, want):
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]


def _assert_split_beats_single(split_err, single_err, names):
    for name, e, e1 in zip(names, split_err, single_err):
        assert e <= SPLIT_TOL, (
            f"{name}: split TF32 max |emulated - plain| / max |plain| = "
            f"{e:.3g} > {SPLIT_TOL}")
        assert e1 >= GAIN_MIN * e, (
            f"{name}: single TF32 {e1:.3g} is not {GAIN_MIN}x the split "
            f"error {e:.3g}")


def test_tf32_rounding_is_rna():
    """The emulated cvt.rna: nearest on the 13 low bits, ties away from
    zero, in both signs; the truncation keeps the top 19 bits."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), one + ulp * (1 + 0.5), 0.0])
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp),
                         one + 2 * ulp, 0.0])
    assert torch.equal(tf32_rna(x), want)
    assert torch.equal(tf32_trunc(x), torch.tensor(
        [one, one, one, -one, one + ulp, 0.0]))
    r = torch.tensor(np.random.default_rng(1).normal(size=1000),
                     dtype=torch.float32)
    hi, lo = split(r)
    assert bool(((tf32_rna(hi) == hi) & (tf32_trunc(lo) == lo)).all())
    # hi + lo recovers x to ~2^-21 of it
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -20


def test_tf32_trunc_split_recovers_x():
    """The wgmma kernels' split (``split_tf32.cuh::lo_trunc``): hi the top
    19 bits of x, lo = x - hi exact in f32 and of x's sign, below one TF32
    ulp of x; hi + trunc(lo) recovers x to 2^-21 of it, and hi alone only
    to 2^-10."""
    r = torch.tensor(np.random.default_rng(2).normal(size=1000) * 3.0,
                     dtype=torch.float32)
    hi, lo = split_trunc(r)
    exact = r - tf32_trunc(r)
    assert bool((tf32_trunc(hi) == hi).all())
    assert bool(((exact == 0) | (torch.sign(exact) == torch.sign(r))).all())
    assert bool((exact.abs() < 2.0 ** -10 * hi.abs() * 2).all())
    rel = ((hi + lo - r).abs() / r.abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((hi - r).abs() / r.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("b,nh,hw", [(1, 2, (64, 64)),   # a global layer
                                     (4, 2, (14, 14))],  # 4 windows
                         ids=["global_64x64", "windows_14x14"])
def test_split_tf32_k5_backward_error(b, nh, hw):
    """K5's products in split TF32 by rounding (``mm_split``, the mma.sync
    kernels' split) over whole rows, against ``packed_attention_bwd_plain``
    in f32, from the plain forward's L and D; the wgmma kernels' own
    arithmetic: ``test_split_tf32_k5_wgmma_error``."""
    qkv, rel_h, rel_w, g = _inputs(b, nh, hw)
    kw = dict(hw=hw, num_heads=nh)
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
    args = (qkv, rel_h, rel_w, g, lse, dvec, nh)
    split_err = _errors(emulated_bwd(*args, mm_split), want)
    single_err = _errors(emulated_bwd(*args, mm_single), want)
    _assert_split_beats_single(split_err, single_err,
                               ("dqkv", "drel_h", "drel_w"))


def _dq_tiles(hw):
    """The key tiles of K5's f32 dq kernel on ``dq_plan_f32``: per tile its
    32 slots' keys (-1: an empty slot), grid rows and grid columns. GRID (W
    <= 16) two grid rows of 16 slots a tile, else 32-slot parts of a grid
    row, ``tpr`` a row."""
    h, w = hw
    plan = port_attn.dq_plan_f32(h * w, hw)
    s = np.arange(32)
    tiles = []
    for t in range(plan.tiles):
        if plan.tpr == 0:
            kr, kc = 2 * t + s // 16, s % 16
        else:
            kr, kc = np.full(32, t // plan.tpr), 32 * (t % plan.tpr) + s
        ok = (kr < h) & (kc < w)
        tiles.append((torch.tensor(np.where(ok, kr * w + kc, -1)), kr, kc))
    return tiles


def _lane_then_quad(parts):
    """A drel_h sum as the kernel takes it: each lane of a quad (t = slot %
    8 // 2) sums its slots' values in slot order, then the quad's four sums
    as ``quad_sum`` adds them, (t0 + t1) + (t2 + t3). ``parts``: (slot,
    value) in the order the kernel meets them."""
    lane = [0.0] * 4
    for slot, x in parts:
        t = slot % 8 // 2
        lane[t] = lane[t] + x
    return (lane[0] + lane[1]) + (lane[2] + lane[3])


def emulated_bwd_wgmma(qkv, rel_h, rel_w, g, lse, dvec, nh, hw, mm):
    """K5's f32 kernels on wgmma (``attn_bwd_dq_wgmma_tf32_kernel``,
    ``attn_bwd_dkv_wgmma_tf32_kernel``), every product through ``mm``:
    the dq kernel walks the key tiles of ``dq_plan_f32`` (empty slots: zero
    rows of K and V, bias -inf, p = 0) and sums dq over them in tile order,
    drel_w of each grid column over the grid rows in order, drel_h of each
    grid row lane by lane then over the quad (``_lane_then_quad``); the
    dk/dv kernel walks query tiles of 32 with the keys as rows (S^T = K .
    Q^T), p and ds in f32, dv += p^T . dO and dk += ds^T . Q a tile at a
    time; the 1/8 after the sums (exact)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    go = _heads(g, nh)
    bias = _bias(rel_h, rel_w)
    h, w = hw
    n = h * w
    lse_, dvec_ = lse[..., None], dvec[..., None]
    dq = torch.zeros_like(q)
    drel_h = torch.zeros_like(rel_h)
    drel_w = torch.zeros_like(rel_w)
    row_parts = {kr: [] for kr in range(h)}
    for keys, kr, kc in _dq_tiles(hw):
        ok = keys >= 0
        idx = keys.clamp(min=0)
        kt = k[..., idx, :] * ok[:, None]
        vt = v[..., idx, :] * ok[:, None]
        bt = torch.where(ok, bias[..., idx], torch.tensor(-torch.inf))
        p = torch.exp(mm(q, kt.transpose(-1, -2)) * 0.125 + bt - lse_)
        ds = p * (mm(go, vt.transpose(-1, -2)) - dvec_)
        dq = dq + mm(ds, kt)
        for slot in range(32):
            if ok[slot]:
                drel_w[..., kc[slot]] += ds[..., slot]
                row_parts[int(kr[slot])].append((slot, ds[..., slot]))
    for kr, parts in row_parts.items():
        drel_h[..., kr] = _lane_then_quad(parts)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, n, 32):
        qs = slice(q0, min(q0 + 32, n))
        p = torch.exp(mm(k, q[..., qs, :].transpose(-1, -2)) * 0.125
                      + bias[..., qs, :].transpose(-1, -2)
                      - lse[..., None, qs])
        ds = p * (mm(v, go[..., qs, :].transpose(-1, -2)) - dvec[..., None, qs])
        dv = dv + mm(p, go[..., qs, :])
        dk = dk + mm(ds, q[..., qs, :])
    dqkv = torch.cat([_merge(dq * 0.125), _merge(dk * 0.125), _merge(dv)],
                     dim=-1)
    return dqkv, drel_h, drel_w


@pytest.mark.parametrize("b,nh,hw", [(1, 2, (64, 64)),   # a global layer
                                     (4, 2, (14, 14)),   # 4 windows
                                     (3, 2, (9, 7)),     # ragged: 63 keys
                                     (1, 2, (20, 24))],  # W = 24: one tile a row
                         ids=["global_64x64", "windows_14x14", "ragged_9x7",
                              "grid_20x24"])
def test_split_tf32_k5_wgmma_error(b, nh, hw):
    """K5's f32 wgmma kernels' own arithmetic (``emulated_bwd_wgmma``: the
    truncation split, the plans' tiles, the drel summation order) against
    ``packed_attention_bwd_plain`` in f32, from the plain forward's L and
    D; one TF32 product of the raw operands is the single-TF32
    yardstick."""
    qkv, rel_h, rel_w, g = _inputs(b, nh, hw)
    kw = dict(hw=hw, num_heads=nh)
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
    args = (qkv, rel_h, rel_w, g, lse, dvec, nh, hw)
    split_err = _errors(emulated_bwd_wgmma(*args, mm_split_trunc), want)
    single_err = _errors(emulated_bwd_wgmma(*args, mm_single_trunc), want)
    _assert_split_beats_single(split_err, single_err,
                               ("dqkv", "drel_h", "drel_w"))


@pytest.mark.parametrize("b,nh,hw", [(4, 2, (14, 14)),   # SAM windows
                                     (3, 2, (9, 7))],    # 63 keys
                         ids=["windows_14x14", "ragged_9x7"])
def test_split_tf32_windowed_forward_error(b, nh, hw):
    """The windowed body (K2, and K7 on the same rows) in split TF32, the
    bias product against the one-hot included, against
    ``packed_attention_plain`` in f32: the output and the logsumexp rows."""
    qkv, rel_h, rel_w, _ = _inputs(b, nh, hw)
    want = port_attn.packed_attention_plain(qkv, rel_h, rel_w, hw=hw,
                                            num_heads=nh, return_lse=True)
    args = (qkv, rel_h, rel_w, nh)
    split_err = _errors(emulated_windowed_fwd(*args, mm_split), want)
    single_err = _errors(emulated_windowed_fwd(*args, mm_single), want)
    _assert_split_beats_single(split_err, single_err, ("out", "lse"))


def emulated_flash_fwd(qkv, rel_h, rel_w, nh, mm, scale, keys):
    """The f32 K1 and K6 on wgmma (``attn_relpos_wgmma_tf32_kernel``): the
    head dim zero-padded to a multiple of 16, tiles of ``keys`` keys (the
    plan's key tile, or for a window its nk / 16 grid rows of W keys: the
    kernel's slots past W and past H hold p = 0), each tile's s = scale *
    (q . k^T) + bias through ``mm`` (the last tile ends at N: the kernel's
    -inf past N gives those keys p = 0), an online softmax (running max m,
    the denominator l and the output rescaled by exp(m_old - m_new)), p in
    f32 into p.v through ``mm``, and o / l last. Returns (out, lse)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    d = q.shape[-1]
    pad = (0, -d % 16)
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    bias = _bias(rel_h, rel_w)
    n = q.shape[2]
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, n, keys):
        s = mm(q, k[..., k0:k0 + keys, :].transpose(-1, -2)) * scale
        s = s + bias[..., k0:k0 + keys]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[..., k0:k0 + keys, :])
        m = m_new
    return _merge(o[..., :d] / l), (m + torch.log(l))[..., 0]


def _flash_keys(d, hw):
    """Keys of a tile of the f32 K1 / K6 on ``relpos_plan_f32``."""
    plan = port_attn.relpos_plan_f32(d, hw[0] * hw[1], hw)
    nk = port_attn.RELPOS_F32_NK
    return nk // 16 * hw[1] if plan.mode == "grid" else nk


@pytest.mark.parametrize("b,nh,d,hw", [(1, 2, 64, (64, 64)),   # K1 global
                                       (1, 2, 80, (64, 64)),   # K6 ViT-H
                                       (4, 2, 80, (14, 14)),   # K6 windows
                                       (2, 2, 20, (12, 10))],  # d padded to 32
                         ids=["k1_global_64x64_d64", "k6_global_64x64_d80",
                              "k6_windows_14x14_d80", "k6_grid_12x10_d20"])
def test_split_tf32_flash_forward_error(b, nh, d, hw):
    """The f32 K1 and K6 on wgmma, in split TF32 by truncation, against the
    plain f32 versions: K1 (d = 64) the output and the logsumexp rows of
    ``packed_attention_plain``, q scaled by 1/8 (exact: the same bits as
    the kernel's 1/8 on the accumulator); K6 the output of
    ``relpos_attention_plain``, d^-1/2 on the accumulator. One TF32 product
    of the raw operands is the single-TF32 yardstick. Tiles of 32 keys (K1,
    ViT-H's global layer), of 2 grid rows of 14 keys (its windows) and of 2
    grid rows of 10 (the 12 x 10 grid)."""
    qkv, rel_h, rel_w, _ = _inputs(b, nh, hw, d=d)
    kw = dict(hw=hw, num_heads=nh)
    args = (qkv, rel_h, rel_w, nh)
    keys = _flash_keys(d, hw)
    if d == 64:
        want = port_attn.packed_attention_plain(*args[:3], return_lse=True,
                                                **kw)
        q8 = qkv.clone()
        q8[..., :nh * d] *= 0.125
        run = lambda mm: emulated_flash_fwd(q8, rel_h, rel_w, nh, mm, 1.0,
                                            keys)
        names = ("out", "lse")
    else:
        want = (port_attn.relpos_attention_plain(*args[:3], **kw),)
        run = lambda mm: emulated_flash_fwd(*args, mm, d ** -0.5, keys)[:1]
        names = ("out",)
    split_err = _errors(run(mm_split_trunc), want)
    single_err = _errors(run(mm_single_trunc), want)
    _assert_split_beats_single(split_err, single_err, names)


# --------------------------------------------------- the decoder: K3, K4 ----
# The f32 K3 / K4 kernels (csrc/decoder_tf32.cuh) at their widths, against
# the f32 plain twins: every output within chip_smoke.py's K34_TOL['f32'],
# 1e-4 of max |plain| (the kernels' own limit), and split TF32 at least
# GAIN_MIN times closer than single TF32 over the outputs. Elementwise steps
# (softmax, LayerNorm, GELU and their backwards, the hypernetwork terms of
# the backward) are exact f32 in the kernels and here.
K34_F32 = 1e-4


def _assert_k34(split_err, single_err, names):
    for name, e in zip(names, split_err):
        assert e <= K34_F32, (
            f"{name}: split TF32 max |emulated - plain| / max |plain| = "
            f"{e:.3g} > {K34_F32}")
    assert max(single_err) >= GAIN_MIN * max(split_err), (
        f"single TF32 {max(single_err):.3g} is not {GAIN_MIN}x the split "
        f"error {max(split_err):.3g}")


def _f32(rng, *shape, k=1.0):
    return torch.tensor(rng.normal(size=shape) * k, dtype=torch.float32)


def _layer_norm(x, eps):
    xc = x - x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _ln_backward(d_y, yn, rstd):
    return rstd * (d_y - d_y.mean(-1, keepdim=True)
                   - yn * (d_y * yn).mean(-1, keepdim=True))


def emulated_k4(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *, pb,
                mm, eps=1e-6):
    """The f32 K4 kernels' arithmetic: the q and out projections, each
    head's scores and p . v, and in the backward d_out = d_res . Wo^T,
    d_p = d_out . v^T, d_score . k and d_qpre . Wq^T through ``mm``.
    Returns (y, the row pass's per-row outputs and per-column sums)."""
    nh, hd = 8, 16
    bp, n_tok, internal = tok_k.shape
    m = keys.shape[1]
    heads = lambda x, n: x.reshape(bp, n, nh, hd).transpose(1, 2)
    q = (mm(keys + pe, wq) + bq) * 0.25
    keys_p = keys
    if pb > 1:
        q, keys_p = q.repeat_interleave(pb, 0), keys.repeat_interleave(pb, 0)
    q4, k4, v4 = heads(q, m), heads(tok_k, n_tok), heads(tok_v, n_tok)
    p = torch.softmax(mm(q4, k4.transpose(-1, -2)), -1)  # (bp, nh, m, t)
    out = mm(p, v4).transpose(1, 2).reshape(bp, m, internal)
    yn, rstd = _layer_norm(keys_p + (mm(out, wo) + bo), eps)
    dres = _ln_backward(dy * g, yn, rstd)
    dout = mm(dres, wo.T)
    dp = mm(heads(dout, m), v4.transpose(-1, -2))
    ds = p * dp - p * (p * dp).sum(-1, keepdim=True)
    dq = (mm(ds, k4) * 0.25).transpose(1, 2).reshape(bp, m, internal)
    dkeys = dres + mm(dq, wq.T)
    pad = lambda x: port_i2t._pad_tokens(x.transpose(1, 2), bp, m, nh)
    rows = (dkeys, dq, pad(p), pad(ds), dout, out, dres)
    sums = (dq.sum((0, 1)), dres.sum((0, 1)), (dy * yn).sum((0, 1)),
            dy.sum((0, 1)))
    return yn * g + bt, rows + sums


def emulated_k3(up, w1, b1, g, bt, w2, b2, hyper, dm, *, mm, eps=1e-6):
    """The f32 K3 kernels' arithmetic: the two upscales, the hypernetwork
    sum over c2 (split TF32 against hyper^T), and in the backward d_u1g =
    d_u2pre . W2^T and d_up = d_u1pre . W1^T through ``mm``; the GELU in
    its erf form. Returns (masks, the row pass's outputs and sums)."""
    bp, m, c = up.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    n_out = hyper.shape[1]
    gelu = lambda x: torch.nn.functional.gelu(x)
    grad = lambda x: port_up._gelu_grad(x, False)
    u1pre = mm(up, w1.reshape(c, 4 * c1)).reshape(bp, m, 4, c1) + b1
    y, rstd = _layer_norm(u1pre, eps)
    out1 = y * g + bt
    u1g = gelu(out1)
    u2pre = mm(u1g, w2.reshape(c1, 4 * c2)) + b2.repeat(4)  # (bp, m, 4, 4 c2)
    u2g = gelu(u2pre)
    masks = mm(u2g.reshape(bp, m * 16, c2), hyper.transpose(1, 2))
    masks = masks.reshape(bp, m, 16, n_out).transpose(2, 3).reshape(bp, m, -1)
    dm5 = dm.reshape(bp, m, n_out, 4, 4)
    d_u2g = torch.einsum("bmtpq,btc->bmpqc", dm5, hyper).reshape(bp, m, 4, -1)
    d_ht = torch.einsum("bmtpq,bmpqc->btpqc", dm5,
                        u2g.reshape(bp, m, 4, 4, c2)).reshape(bp, n_out, -1)
    d_u2pre = d_u2g * grad(u2pre)
    d_out1 = mm(d_u2pre, w2.reshape(c1, 4 * c2).T) * grad(out1)
    d_u1pre = _ln_backward(d_out1 * g, y, rstd).reshape(bp, m, 4 * c1)
    d_up = mm(d_u1pre, w1.reshape(c, 4 * c1).T)
    rows = (d_up, u1g.reshape(bp, m, -1), d_u2pre.reshape(bp, m, -1),
            d_u1pre)
    sums = (d_u1pre.sum((0, 1)), (d_out1 * y).sum((0, 1)).reshape(-1),
            d_out1.sum((0, 1)).reshape(-1), d_u2pre.sum((0, 1)).reshape(-1),
            d_ht)
    return masks, rows + sums


def _k4_case(rng, bimg, pb, n_tok, m):
    bp = bimg * pb
    args = (_f32(rng, bimg, m, 256), _f32(rng, 1, m, 256),
            _f32(rng, bp, n_tok, 128), _f32(rng, bp, n_tok, 128),
            _f32(rng, 256, 128, k=0.06), _f32(rng, 128, k=0.1),
            _f32(rng, 128, 256, k=0.09), _f32(rng, 256, k=0.1),
            1 + _f32(rng, 256, k=0.1), _f32(rng, 256, k=0.1))
    return args, _f32(rng, bp, m, 256)


def _k3_case(rng, bp, m, n_out):
    args = (_f32(rng, bp, m, 256), _f32(rng, 256, 2, 2, 64, k=0.06),
            _f32(rng, 64, k=0.1), 1 + _f32(rng, 64, k=0.1),
            _f32(rng, 64, k=0.1), _f32(rng, 64, 2, 2, 32, k=0.12),
            _f32(rng, 32, k=0.1), _f32(rng, bp, n_out, 32))
    return args, _f32(rng, bp, m, n_out * 16)


@pytest.mark.parametrize("pb,n_tok", [(1, 7), (3, 5)], ids=["pb1", "pb3"])
def test_split_tf32_k4_chain_error(pb, n_tok):
    """K4's forward (y) and row pass (d_keys, d_qpre, p, d_score, d_out, the
    rnd(out) and d_res rows, dbq, dbo, dg, dbt) in split TF32 against
    ``i2t_fwd_plain`` / ``i2t_bwd_rows_plain``, on a ragged 37 rows."""
    args, dy = _k4_case(np.random.default_rng(11), 2, pb, n_tok, 37)
    kw = dict(nh=8, pb=pb, eps=1e-6)
    want = (port_i2t.i2t_fwd_plain(*args, **kw),
            *port_i2t.i2t_bwd_rows_plain(*args, dy, **kw))
    run = lambda mm: (lambda r: (r[0], *r[1]))(
        emulated_k4(*args, dy, pb=pb, mm=mm))
    names = ("y", "d_keys", "d_qpre", "p", "d_score", "d_out", "out_rows",
             "dres_rows", "dbq", "dbo", "dg", "dbt")
    _assert_k34(_errors(run(mm_split), want), _errors(run(mm_single), want),
                names)


@pytest.mark.parametrize("n_out", [1, 3])
def test_split_tf32_k3_chain_error(n_out):
    """K3's forward (masks) and row pass (d_up, u1g, d_u2pre, d_u1pre rows,
    db1, dg, dbt, db2, d_hyper) in split TF32 against
    ``upscale_fwd_plain`` / ``upscale_bwd_rows_plain``, on a ragged 37
    rows."""
    args, dm = _k3_case(np.random.default_rng(12), 3, 37, n_out)
    want = (port_up.upscale_fwd_plain(*args),
            *port_up.upscale_bwd_rows_plain(args[0], dm, *args[1:]))
    run = lambda mm: (lambda r: (r[0], *r[1]))(
        emulated_k3(*args, dm, mm=mm))
    names = ("masks", "d_up", "u1g", "d_u2pre", "d_u1pre", "db1", "dg", "dbt",
             "db2", "d_hyper")
    _assert_k34(_errors(run(mm_split), want), _errors(run(mm_single), want),
                names)


def chain_split(acc, a, b):
    """acc + a . b as the f32 K4 weight pass adds one TF32 k-step into its
    accumulator: lo.hi, then hi.lo, then hi.hi, each added in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ((acc + al @ bh) + ah @ bl) + ah @ bh


def chain_single(acc, a, b):
    return acc + tf32_rna(a) @ tf32_rna(b)


def emulated_dw_chain(x, y, parts, chain, align):
    """The f32 K3 / K4 weight passes' split-K sum x^T . y over rows: the
    row chunks of ``kernels.row_chunks`` aligned to the pass's stage
    (``align``: ``DW32_ROWS``), each chunk one accumulator chain of 8-row
    k-steps (``chain``), the chunks' partials added in order."""
    total = 0.0
    for lo, hi in kernels.row_chunks(x.shape[0], parts, align):
        acc = torch.zeros(x.shape[1], y.shape[1])
        for s in range(lo, hi, 8):
            acc = chain(acc, x[s:min(hi, s + 8)].T, y[s:min(hi, s + 8)])
        total = total + acc
    return total


@pytest.mark.parametrize("op,parts", [("k4", 1), ("k4", 3), ("k3", 1),
                                      ("k3", 3)])
def test_split_tf32_weight_pass_error(op, parts):
    """The weight passes (K4: dWq, dWo; K3: dW1, dW2; each one accumulator
    chain of TF32 k-steps per chunk, as both f32 weight passes on wgmma) as
    split-K sums over the kernels' row chunks in split TF32, on the row
    pass's own scratch rows, against ``i2t_bwd_dw_plain`` /
    ``upscale_bwd_dw_plain`` (one product over all rows): 2 x 37 and 3 x
    37 rows, in 1 or 3 chunks."""
    rng = np.random.default_rng(13)
    if op == "k4":
        pb = 2
        args, dy = _k4_case(rng, 1, pb, 7, 37)
        rows = port_i2t.i2t_bwd_rows_plain(*args, dy, nh=8, pb=pb, eps=1e-6)
        keys, pe = args[:2]
        dqpre, out_rows, dres = rows[1], rows[5], rows[6]
        want = port_i2t.i2t_bwd_dw_plain(keys, pe, dqpre, out_rows, dres,
                                         pb=pb)
        qin = (keys + pe).repeat_interleave(pb, 0).reshape(-1, 256)
        flat = lambda t: t.reshape(-1, t.shape[-1])

        def run(mm):
            chain = chain_split if mm is mm_split else chain_single
            align = port_i2t.DW32_ROWS
            return (emulated_dw_chain(flat(dqpre), qin, parts, chain,
                                      align).T,
                    emulated_dw_chain(flat(out_rows), flat(dres), parts,
                                      chain, align))
    else:
        args, dm = _k3_case(rng, 3, 37, 2)
        rows = port_up.upscale_bwd_rows_plain(args[0], dm, *args[1:])
        up, u1g, d2, du1 = (args[0],) + rows[1:4]
        want = port_up.upscale_bwd_dw_plain(up, u1g, d2, du1)
        n = up.shape[0] * up.shape[1]
        x2, y2 = u1g.reshape(n, 4, -1), d2.reshape(n, 4, -1)

        def run(mm):
            chain = chain_split if mm is mm_split else chain_single
            dw = functools.partial(emulated_dw_chain, parts=parts,
                                   chain=chain, align=port_up.DW32_ROWS)
            return (dw(up.reshape(n, -1), du1.reshape(n, -1)),
                    torch.stack([dw(x2[:, de], y2[:, de])
                                 for de in range(4)]))
    _assert_k34(_errors(run(mm_split), want), _errors(run(mm_single), want),
                ("dW_a", "dW_b"))
