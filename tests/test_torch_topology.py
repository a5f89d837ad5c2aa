"""The port's topological loss against the JAX package, on the CPU: the host
library's bars (``ops/native.py``, built with g++ from ``csrc/``) and the
plain twin of the card's kernels (``ops/topology_device.py`` on CPU tensors)
against JAX's ``topology_ref`` and the boundary-matrix oracle, the matching,
the resize, and the losses (host pairing, a given pairing, the device twin)
with their gradients.

Inputs are made with numpy from a seed. No JAX function here loads the JAX
package's own native library (its loader runs ``make`` in ``native/``): the
references are JAX ``topology_ref``, ``topology_device`` and
``topo_loss_from_pairing`` with a given pairing.

Tolerances: bars are compared exactly (index pairs; above the bar cap the
multisets of persistence values); matching costs within rtol 1e-5; losses
within rtol 2e-5 / atol 1e-6 and gradients within rtol 1e-4 / atol 1e-6,
the limits of the JAX package's ``tests/test_topology_device.py``; the
resize within 1e-6 (f32 rounding of the same lerp)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops import topology as jt
from dilabhelmholtzoct_tpu.ops import topology_device as jtd
from dilabhelmholtzoct_tpu.ops import topology_ref as jref
from dilabhelmholtzoct_tpu_torch.ops import native
from dilabhelmholtzoct_tpu_torch.ops import topology as pt
from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd
from persistence_oracle import persistence_by_reduction


def _sigmoid_noise(rng, shape):
    return (1 / (1 + np.exp(-rng.normal(size=shape)))).astype(np.float32)


GRIDS = {
    "random": lambda rng: rng.random((4, 7, 9)).astype(np.float32),
    "plateaus": lambda rng: (np.round(rng.random((4, 12, 12)) * 3) / 3)
    .astype(np.float32),
    "saturated": lambda rng: np.minimum(
        _sigmoid_noise(rng, (3, 16, 16)) * 1.5, 1.0).astype(np.float32),
    "binary": lambda rng: (rng.random((3, 14, 14)) > 0.6).astype(np.float32),
    "constant": lambda rng: np.full((2, 10, 10), 0.5, np.float32),
    "row_1xN": lambda rng: rng.random((3, 1, 17)).astype(np.float32),
    "col_Nx1": lambda rng: rng.random((3, 17, 1)).astype(np.float32),
    "sigmoid_50x50": lambda rng: _sigmoid_noise(rng, (2, 50, 50)),
}


def _pairs(birth, death, count):
    return [sorted(zip(birth[i, :count[i]].tolist(),
                       death[i, :count[i]].tolist()))
            for i in range(len(count))]


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_bars_match_jax_reference(case):
    """The host library and the plain twin against JAX ``topology_ref``:
    equal index-pair multisets in H0 and H1 and the same essential class;
    the twin equal to the host library index for index, in the same order
    (one tie order: by value, then by index)."""
    grids = GRIDS[case](np.random.default_rng(sorted(GRIDS).index(case)))
    k = 1400  # above every bar count here: no cap
    host = native.cubical_pairs_batch(grids, k)
    for dim in (0, 1):
        want = [sorted(map(tuple, jref.cubical_pairs(g)[f"h{dim}"].tolist()))
                for g in grids]
        hb, hd = host[f"h{dim}_birth"], host[f"h{dim}_death"]
        hc = host["counts"][:, dim]
        assert _pairs(hb, hd, hc) == want
        twin = ptd.cubical_pairs_plain(torch.tensor(grids), dim, k)
        for a, b in zip(twin, (hb, hd, hc)):
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        host["h0_essential"],
        [jref.cubical_pairs(g)["h0_essential"] for g in grids])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bars_match_boundary_matrix_oracle(seed):
    """Bar values of the host library against the textbook reduction of the
    T-construction (an independent algorithm), plateaus included."""
    rng = np.random.default_rng(seed)
    grids = np.stack([rng.random((6, 8)),
                      np.round(rng.random((6, 8)) * 3) / 3]).astype(np.float32)
    host = native.cubical_pairs_batch(grids, 64)
    for i, g in enumerate(grids):
        want = persistence_by_reduction(g)
        flat = g.reshape(-1).astype(np.float64)
        for dim in (0, 1):
            c = host["counts"][i, dim]
            got = sorted(zip(flat[host[f"h{dim}_birth"][i, :c]],
                             flat[host[f"h{dim}_death"][i, :c]]))
            assert got == sorted(map(tuple, np.asarray(want[f"h{dim}"])
                                     .tolist()))


@pytest.mark.parametrize("grid_kind", ["noise", "ties"])
def test_bar_cap_keeps_most_persistent(grid_kind):
    """Above the cap: the persistence values kept are the JAX reference's
    most persistent ones, and the kept bars and their order are one rule
    (larger persistence first, ties in emission order) in the host library
    and the twin."""
    rng = np.random.default_rng(7)
    grids = (_sigmoid_noise(rng, (2, 50, 50)) if grid_kind == "noise" else
             (np.round(rng.random((2, 40, 40)) * 6) / 6).astype(np.float32))
    k = 24
    host = native.cubical_pairs_batch(grids, k)
    for dim in (0, 1):
        twin = ptd.cubical_pairs_plain(torch.tensor(grids), dim, k)
        for a, b in zip(twin, (host[f"h{dim}_birth"], host[f"h{dim}_death"],
                               host["counts"][:, dim])):
            np.testing.assert_array_equal(a.numpy(), b)
        for i, g in enumerate(grids):
            flat = g.reshape(-1)
            bars = jref.cubical_pairs(g)[f"h{dim}"]
            assert len(bars) > k
            pers = np.sort(np.abs(flat[bars[:, 1]] - flat[bars[:, 0]]))[-k:]
            got = np.abs(flat[host[f"h{dim}_death"][i]]
                         - flat[host[f"h{dim}_birth"][i]])
            assert host["counts"][i, dim] == k
            np.testing.assert_array_equal(np.sort(got), pers)
            assert np.all(np.diff(got) <= 0)  # kept in persistence order


def _cost(d1, d2, matched_pairs, q):
    """The partial matching's cost: matched pairs at the L-inf distance,
    everything else at its diagonal distance, ^q."""
    m1 = {r for r, _ in matched_pairs}
    m2 = {c for _, c in matched_pairs}
    total = sum(max(abs(d1[r, 0] - d2[c, 0]), abs(d1[r, 1] - d2[c, 1])) ** q
                for r, c in matched_pairs)
    total += sum((abs(d1[r, 1] - d1[r, 0]) / 2) ** q
                 for r in range(len(d1)) if r not in m1)
    total += sum((abs(d2[c, 1] - d2[c, 0]) / 2) ** q
                 for c in range(len(d2)) if c not in m2)
    return total


@pytest.mark.parametrize("q", [1.0, 2.0])
def test_matching_cost_matches_jax_reference(q):
    """The host library's matching (and the twin's) reaches the cost of JAX
    ``topology_ref.wasserstein_match`` within rtol 1e-5, with the small
    diagram on either side (pred noise against binary targets, and against
    noise)."""
    rng = np.random.default_rng(int(q))
    pred = _sigmoid_noise(rng, (6, 20, 20))
    true = np.concatenate([(rng.random((3, 20, 20)) > 0.5),
                           _sigmoid_noise(rng, (3, 20, 20))]).astype(np.float32)
    k = 512
    pp = native.cubical_pairs_batch(pred, k)
    diagrams = pt.true_diagrams_from_grids(true, 1, k)
    pb, pd, pc = pp["h1_birth"], pp["h1_death"], pp["counts"][:, 1]
    matched, target, const = native.wasserstein_match_batch(
        pred, pb, pd, pc, diagrams, q, k)
    tb = np.zeros((6, k, 2), np.float32)
    tc = np.array([len(d) for d in diagrams], np.int32)
    for i, d in enumerate(diagrams):
        tb[i, :len(d)] = d
    twin = ptd.wasserstein_match_plain(
        torch.tensor(pred.reshape(6, -1)), torch.tensor(pb), torch.tensor(pd),
        torch.tensor(pc), torch.tensor(tb), torch.tensor(tc), q)
    for i in range(6):
        flat = pred[i].reshape(-1)
        d1 = np.stack([flat[pb[i, :pc[i]]], flat[pd[i, :pc[i]]]], 1)
        d2 = diagrams[i]
        m, _, _ = jref.wasserstein_match(d1, d2, q)
        want = _cost(d1.astype(np.float64), d2.astype(np.float64),
                     [tuple(x) for x in m], q)
        for mt, tg, ct in ((matched, target, const),
                           tuple(x.numpy() for x in twin)):
            sel = mt[i, :pc[i]].astype(bool)
            got = float(ct[i]) + sum(
                max(abs(d1[r, 0] - tg[i, r, 0]), abs(d1[r, 1] - tg[i, r, 1]))
                ** q if sel[r] else (abs(d1[r, 1] - d1[r, 0]) / 2) ** q
                for r in range(pc[i]))
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_resize_matches_jax():
    """Values and vector-Jacobian products of the align-corners resize,
    downsampling and upsampling, against JAX."""
    rng = np.random.default_rng(0)
    for (h, w), out in (((48, 64), (16, 16)), ((7, 9), (20, 13))):
        x = rng.normal(size=(2, 3, h, w)).astype(np.float32)
        ct = rng.normal(size=(2, 3, *out)).astype(np.float32)
        yj, vjp = jax.vjp(lambda a: jt.resize_align_corners(a, out),
                          jnp.asarray(x))
        (gj,) = vjp(jnp.asarray(ct))
        xp = torch.tensor(x, requires_grad=True)
        yp = pt.resize_align_corners(xp, out)
        yp.backward(torch.tensor(ct))
        np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yj),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(xp.grad.numpy(), np.asarray(gj),
                                   atol=1e-6, rtol=1e-6)


def _inputs(seed, b=2, c=3, hw=(24, 30)):
    rng = np.random.default_rng(seed)
    pred = _sigmoid_noise(rng, (b, c, *hw))
    true = (rng.random((b, c, *hw)) > 0.5).astype(np.float32)
    cm = np.ones((b, c), np.float32)
    cm[-1, -1] = 0.0  # one bucket-padding channel
    return pred, true, cm


def _port_loss_and_grad(fn, pred, *args, **kw):
    p = torch.tensor(pred, requires_grad=True)
    loss = fn(p, *args, **kw)
    loss.backward()
    return float(loss), p.grad.numpy()


@pytest.mark.parametrize("feat_d,loss_q,loss_r,masked", [
    (1, 2, False, True), (0, 2, False, True), (2, 2, False, True),
    (1, 1, False, False), (1, 2, True, True), (0, 1, True, False)])
def test_losses_match_jax_device_loss(feat_d, loss_q, loss_r, masked):
    """``topo_loss`` (host pairing), ``topo_loss_device`` (the CPU twin) and
    ``topo_loss_from_pairing`` (with the port's host pairing, beside JAX's
    ``topo_loss_from_pairing`` on the same pairing) against JAX
    ``topo_loss_device``: loss rtol 2e-5 / atol 1e-6, gradient rtol 1e-4 /
    atol 1e-6."""
    pred, true, cm = _inputs(11 + feat_d + loss_q)
    kw = dict(lamda=0.1, interp=16, feat_d=feat_d, loss_q=loss_q,
              loss_r=loss_r)
    jcm = jnp.asarray(cm) if masked else None
    pcm = torch.tensor(cm) if masked else None
    jl, jg = jax.value_and_grad(lambda p: jtd.topo_loss_device(
        p, jnp.asarray(true), channel_mask=jcm, **kw))(jnp.asarray(pred))
    jl, jg = float(jl), np.asarray(jg)
    assert np.any(jg != 0) or feat_d == 2

    pred_g, true_g = pt.downsample_for_topo(torch.tensor(pred),
                                            torch.tensor(true), 16)
    pairing = pt.host_pairing(
        pred_g.reshape(-1, 16, 16).numpy(), true_g.reshape(-1, 16, 16).numpy(),
        feat_d=feat_d, q=float(loss_q),
        row_mask=cm.reshape(-1) if masked else None)
    pair_kw = dict(lamda=0.1, interp=16, loss_q=loss_q, loss_r=loss_r)
    results = {
        "topo_loss": _port_loss_and_grad(pt.topo_loss, pred,
                                         torch.tensor(true),
                                         channel_mask=pcm, **kw),
        "topo_loss_device": _port_loss_and_grad(
            ptd.topo_loss_device, pred, torch.tensor(true), channel_mask=pcm,
            **kw),
        "topo_loss_from_pairing": _port_loss_and_grad(
            pt.topo_loss_from_pairing, pred, pairing, channel_mask=pcm,
            **pair_kw),
    }
    jp_l, jp_g = jax.value_and_grad(lambda p: jt.topo_loss_from_pairing(
        p, {k: jnp.asarray(v) for k, v in pairing.items()},
        channel_mask=jcm, **pair_kw))(jnp.asarray(pred))
    results["jax topo_loss_from_pairing"] = (float(jp_l), np.asarray(jp_g))
    for name, (loss, grad) in results.items():
        np.testing.assert_allclose(loss, jl, rtol=2e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(grad, jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_training_geometry_loss_matches_jax():
    """The training call: lambda 0.1, interp 50, H1, q 2, a bucket-padding
    channel, targets of square blobs (the JAX package's geometry test)."""
    rng = np.random.default_rng(42)
    b, c = 2, 4
    pred = _sigmoid_noise(rng, (b, c, 64, 64))
    true = np.zeros((b, c, 64, 64), np.float32)
    for i in range(b):
        for j in range(c):
            y, x = rng.integers(8, 40, 2)
            true[i, j, y:y + 16, x:x + 16] = 1.0
    cm = np.ones((b, c), np.float32)
    cm[:, -1] = 0.0
    kw = dict(lamda=0.1, interp=50, feat_d=1, loss_q=2)
    jl, jg = jax.value_and_grad(lambda p: jtd.topo_loss_device(
        p, jnp.asarray(true), channel_mask=jnp.asarray(cm), **kw))(
            jnp.asarray(pred))
    for fn in (pt.topo_loss, ptd.topo_loss_device):
        loss, grad = _port_loss_and_grad(fn, pred, torch.tensor(true),
                                         channel_mask=torch.tensor(cm), **kw)
        np.testing.assert_allclose(loss, float(jl), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


def test_zero_lambda_returns_zero():
    x = torch.zeros((1, 1, 8, 8))
    for fn in (pt.topo_loss, ptd.topo_loss_device):
        assert fn(x, x, 0.0) == 0.0 == jtd.topo_loss_device(
            jnp.zeros((1, 1, 8, 8)), jnp.zeros((1, 1, 8, 8)), 0.0)


def _large_grids(size, seed):
    """A grid of sigmoid noise and one of blobs (plateaus), size x size."""
    from test_torch_topology_parallel import _blobs

    rng = np.random.default_rng(seed)
    return np.concatenate([_sigmoid_noise(rng, (1, size, size)),
                           _blobs(rng, 1, size, size)])


@pytest.mark.parametrize("size", [215, 255])
def test_large_grids_match_jax_native(size):
    """Past one block's shared memory (the card's global route, int32
    slots): the kernel's phases (``native.cubical_pairs_parallel``, 256
    virtual threads) against the JAX package's native
    ``cubical_pairs_batch``: uncapped, index for index in both passes; at
    the 512 cap, the kept bars' persistence values."""
    from dilabhelmholtzoct_tpu.ops import native as jnative

    grids = _large_grids(size, size)
    for k in (40000, 512):  # 40000: above every bar count here
        want = jnative.cubical_pairs_batch(grids, k)
        for dim in (0, 1):
            b, d, c, _ = native.cubical_pairs_parallel(grids, dim, k, 256)
            np.testing.assert_array_equal(c, want["counts"][:, dim])
            wb, wd = want[f"h{dim}_birth"], want[f"h{dim}_death"]
            if k > 512:
                assert (c < k).all()
                np.testing.assert_array_equal(b, wb)
                np.testing.assert_array_equal(d, wd)
                continue
            for i, g in enumerate(grids.reshape(len(grids), -1)):
                n = c[i]
                np.testing.assert_array_equal(
                    np.sort(np.abs(g[d[i, :n]] - g[b[i, :n]])),
                    np.sort(np.abs(g[wd[i, :n]] - g[wb[i, :n]])))


def test_100x100_h1_matches_jax_device_pairing():
    """A 100x100 grid of noise and one of blobs, H1, capped at 512: the
    port's ``device_cubical_pairs`` on the CPU (the plain twin) and the
    card's phases (``native.cubical_pairs_parallel``) give the bar pairs of
    JAX's ``device_cubical_pairs`` (its own order: compared as sets)."""
    grids = _large_grids(100, 100)
    jb, jd, jc = map(np.asarray, jtd.device_cubical_pairs(
        jnp.asarray(grids), 1, pt.MAX_BARS))
    twin = [t.numpy() for t in ptd.device_cubical_pairs(
        torch.from_numpy(grids), 1, pt.MAX_BARS)]
    phases = native.cubical_pairs_parallel(grids, 1, pt.MAX_BARS, 256)[:3]
    want = _pairs(jb, jd, jc)
    assert _pairs(*twin) == want and _pairs(*phases) == want
    assert jc[0] == pt.MAX_BARS > jc[1]  # the cap acts on the noise grid


def test_device_functions_on_cpu_and_unknown_devices():
    """On CPU tensors the device functions run the plain twin (no launch);
    ``device_pairing`` returns the host pairing's dict on the grids'
    device; a device with no kernel raises."""
    pred, true, _ = _inputs(3, 1, 2, (16, 16))
    before = dict(ptd.LAUNCHES)
    pairing = ptd.device_pairing(torch.tensor(pred[0]), torch.tensor(true[0]),
                                 1, 2.0)
    assert ptd.LAUNCHES == before
    host = pt.host_pairing(pred[0], true[0], feat_d=1)
    for k in ("p_birth", "p_death", "const_term"):
        np.testing.assert_array_equal(pairing[k].numpy(), host[k])
    meta = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no cubical_pairs kernel"):
        ptd.device_cubical_pairs(meta, 1)


def test_host_library_builds_into_build_and_raises_on_failure(tmp_path,
                                                              monkeypatch):
    """The library lands under ``build/native/`` (never ``native/``), named
    by its sources' hash; a failed build raises with the compiler's output
    and leaves no file behind."""
    path = native.library_path()
    assert path.parent.parts[-2:] == ("build", "native")
    assert native.build() == path and path.exists()
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'compiler says no' >&2\nexit 1\n")
    cxx.chmod(0o755)
    out = tmp_path / "out"
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)failed.*compiler says no"):
        native.build()
    assert list(out.iterdir()) == []
