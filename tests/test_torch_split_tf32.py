"""The error of the split-TF32 products of the f32 encoder attention kernels
on the tensor cores (``csrc/attention_tf32.cuh``: K5's backward, the
windowed body of K2 / K7 and the flash body of K1 / K6), emulated on the
CPU.

A kernel splits each f32 operand x as hi = tf32(x) (rounded as
``cvt.rna.tf32.f32`` rounds: to nearest on the 13 low mantissa bits, ties
away from zero; the kernels add half a TF32 ulp to the bits and clear the 13
low ones, as ``tf32_rna`` below) and lo = x - hi, whose top 19 bits the
tensor cores read (truncation, emulated as such), and takes a product a.b as
lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 accumulation. Products of TF32
values are exact in f32, so an f32 matmul of the split operands on the CPU
emulates the tensor cores up to the order of the f32 sums.

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

import numpy as np
import pytest
import torch

from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn

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


@pytest.mark.parametrize("b,nh,hw", [(1, 2, (64, 64)),   # a global layer
                                     (4, 2, (14, 14))],  # 4 windows
                         ids=["global_64x64", "windows_14x14"])
def test_split_tf32_k5_backward_error(b, nh, hw):
    """K5's products in split TF32 against ``packed_attention_bwd_plain``
    in f32, from the plain forward's L and D."""
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


def emulated_flash_fwd(qkv, rel_h, rel_w, nh, mm, scale, tile=64):
    """The flash body of K1 and K6 (``attention_tf32.cuh::flash_tf32``):
    the head dim zero-padded to a multiple of 8, 64-key tiles, each tile's
    s = scale * (q . k^T) + bias through ``mm`` (the last tile ends at N:
    the kernel's -inf past N gives those keys p = 0), an
    online softmax (running max m, the denominator l and the output rescaled
    by exp(m_old - m_new)), p in f32 into p.v through ``mm``, and o / l
    last. Returns (out, lse)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    d = q.shape[-1]
    pad = (0, -d % 8)
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    bias = _bias(rel_h, rel_w)
    n = q.shape[2]
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, n, tile):
        s = mm(q, k[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        s = s + bias[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[..., k0:k0 + tile, :])
        m = m_new
    return _merge(o[..., :d] / l), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("b,nh,d,hw", [(1, 2, 64, (64, 64)),   # K1 global
                                       (1, 2, 80, (64, 64)),   # K6 ViT-H
                                       (4, 2, 80, (14, 14)),   # K6 windows
                                       (2, 2, 20, (12, 10))],  # d padded to 24
                         ids=["k1_global_64x64_d64", "k6_global_64x64_d80",
                              "k6_windows_14x14_d80", "k6_grid_12x10_d20"])
def test_split_tf32_flash_forward_error(b, nh, d, hw):
    """The flash body (K1 f32, K6 f32) in split TF32 against the plain f32
    versions: K1 (d = 64) the output and the logsumexp rows of
    ``packed_attention_plain``, q scaled by 1/8 (exact: the same bits as
    the kernel's 1/8 on the accumulator); K6 the output of
    ``relpos_attention_plain``, d^-1/2 on the accumulator. The windows'
    last tile holds 196 - 192 = 4 keys, the 12 x 10 grid's 120 - 64 = 56."""
    qkv, rel_h, rel_w, _ = _inputs(b, nh, hw, d=d)
    kw = dict(hw=hw, num_heads=nh)
    args = (qkv, rel_h, rel_w, nh)
    if d == 64:
        want = port_attn.packed_attention_plain(*args[:3], return_lse=True,
                                                **kw)
        q8 = qkv.clone()
        q8[..., :nh * d] *= 0.125
        run = lambda mm: emulated_flash_fwd(q8, rel_h, rel_w, nh, mm, 1.0)
        names = ("out", "lse")
    else:
        want = (port_attn.relpos_attention_plain(*args[:3], **kw),)
        run = lambda mm: emulated_flash_fwd(*args, mm, d ** -0.5)[:1]
        names = ("out",)
    split_err = _errors(run(mm_split), want)
    single_err = _errors(run(mm_single), want)
    _assert_split_beats_single(split_err, single_err, names)
