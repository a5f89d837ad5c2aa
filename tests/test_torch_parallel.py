"""The port's data parallelism (``parallel/``) against the JAX package on
the CPU: ``pad_to_multiple`` and ``process_slice`` against JAX's,
``initialize``'s single-process passthrough and warnings, and one train step
and one eval step of two ranks over gloo (``tests/torch_dp_worker.py``) on
a padded batch whose halves hold unequal channel counts, against the port's
single-process step and JAX's ``make_train_step`` on the whole padded batch
— the JAX package's sharded step is that single-device step.

Limits: rtol 1e-4, the tolerance of the JAX package's DP tests
(``tests/test_training.py``); a gradient or parameter tensor also within
1e-4 of its own max |value| (entries near zero), at least 1e-8 (the key
projections' biases have a zero gradient but for rounding: softmax ignores
a constant per row)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.parallel import distributed as jdist
from dilabhelmholtzoct_tpu.parallel import mesh as jmesh
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.parallel import distributed as pdist
from dilabhelmholtzoct_tpu_torch.parallel import mesh as pmesh
from test_torch_train import _params
from torch_dp_worker import LR, MODES, ORIG_HW, run_pair, step_results

RTOL = 1e-4
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _host_batch(rng, b, c, keys):
    out = {"prompts": rng.uniform(0, 60, (b, c, 4)).astype(np.float32),
           "channel_mask": np.ones((b, c), np.float32),
           "comp_map": rng.integers(0, c + 1, (b, 6, 8)).astype(np.int32),
           "indices": np.arange(b, dtype=np.int32),
           "image": rng.integers(0, 255, (b, 6, 8, 3)).astype(np.uint8),
           "point_labels": rng.integers(-1, 2, (b, c, 2)).astype(np.int32)}
    return {k: out[k] for k in keys}


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("keys", [
    ("prompts", "channel_mask", "comp_map", "indices", "image",
     "point_labels"),
    ("prompts", "comp_map"),
    ("channel_mask", "indices"),
], ids=["all", "no_mask_no_indices", "mask_and_indices"])
def test_pad_to_multiple_matches_jax(rng, multiple, keys):
    """Bit for bit, dtypes included, over batch sizes 1-9: zero rows,
    zero ``channel_mask`` and the ``-1`` sentinel on the pad rows."""
    for b in range(1, 10):
        batch = _host_batch(rng, b, 3, keys)
        want, n_want = jmesh.pad_to_multiple(
            {k: v.copy() for k, v in batch.items()}, multiple)
        got, n_got = pmesh.pad_to_multiple(
            {k: v.copy() for k, v in batch.items()}, multiple)
        assert n_got == n_want == b
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert next(iter(got.values())).shape[0] % multiple == 0


@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
def test_process_slice_matches_jax(monkeypatch, count):
    """Every rank's slice of every padded row count against JAX's formula
    (``jax.process_count`` / ``process_index`` patched), and the same
    assert on an unpadded count."""
    for index in range(count):
        monkeypatch.setattr(jdist.jax, "process_count", lambda: count)
        monkeypatch.setattr(jdist.jax, "process_index", lambda: index)
        monkeypatch.setattr(pdist, "process_count", lambda: count)
        monkeypatch.setattr(pdist, "process_index", lambda: index)
        for n in range(count, 6 * count + 1, count):
            assert pdist.process_slice(n) == jdist.process_slice(n)
        if count > 1:
            with pytest.raises(AssertionError):
                pdist.process_slice(count + 1)
            with pytest.raises(AssertionError):
                jdist.process_slice(count + 1)


def test_initialize_single_process_passthrough(monkeypatch):
    """No env: a no-op that returns False (``tests/test_parallel.py``'s
    passthrough), one process of index 0 owning every row, and the helpers
    the loss and the step use are the identity."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False
    assert not pdist.is_initialized()
    assert (pdist.process_count(), pdist.process_index()) == (1, 0)
    assert pdist.process_slice(8) == slice(0, 8)
    batch = {"x": np.arange(8).reshape(4, 2)}
    np.testing.assert_array_equal(pmesh.shard_batch(batch)["x"], batch["x"])
    x = torch.arange(6, dtype=torch.float32)
    assert pdist.global_count(x) is x
    assert torch.equal(pdist.mean_share(x), x.mean())
    t = x.clone()
    pdist.all_reduce_sum_([t])
    pmesh.replicate([t])
    assert torch.equal(t, x)


@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "2"},
    {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2", "RANK": "0"},
    {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "RANK": "1"},
], ids=["world_only", "no_port", "no_world"])
@pytest.mark.parametrize("explicit", [False, True])
def test_initialize_partial_env_warns_and_is_ignored(monkeypatch, env,
                                                     explicit):
    """Partial coordinator information warns and runs single-process (JAX's
    rule): never a group, never a raise."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.warns(RuntimeWarning, match="partial multihost"):
        assert pdist.initialize(explicit=explicit) is False
    assert not pdist.is_initialized()


def test_initialize_explicit_without_cluster_warns(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(RuntimeWarning, match="continuing SINGLE-process"):
        assert pdist.initialize(explicit=True) is False
    assert not pdist.is_initialized()


def _case_inputs():
    """sam_tiny JAX parameters (perturbed init) and a batch of 3 padded to
    4: channel counts 4, 3 | 1, 0 on the two ranks, cached embeddings."""
    cfg = jconfigs.sam_tiny(128)
    tree = _params(cfg, seed=5)
    rng = np.random.default_rng(7)
    b, c = 3, 4
    img = rng.integers(0, 255, (b, *ORIG_HW, 3)).astype(np.uint8)
    comp = np.zeros((b, *ORIG_HW), np.int32)
    boxes = np.zeros((b, c, 4), np.float32)
    for i in range(b):
        for j in range(c):
            y, x = int(rng.integers(2, 24)), int(rng.integers(2, 32))
            h, w = int(rng.integers(8, 22)), int(rng.integers(8, 30))
            comp[i, y:y + h, x:x + w] = j + 1
            boxes[i, j] = (x, y, x + w, y + h)
    mask = np.zeros((b, c), np.float32)
    for i, n in enumerate((4, 3, 1)):
        mask[i, :n] = 1.0
    pix, _ = jtr.preprocess_image(jnp.asarray(img), target_size=128)
    emb = np.asarray(jsam.encode_image(jax.tree.map(jnp.asarray, tree), pix,
                                       cfg))
    batch, _ = pmesh.pad_to_multiple(
        {"embeddings": emb, "prompts": boxes, "comp_map": comp,
         "channel_mask": mask, "indices": np.arange(b, dtype=np.int32)}, 2)
    return cfg, tree, batch


def _jax_results(cfg, tree, batch):
    """JAX's eval-step loss, train-step loss, gradients (an optax
    transformation that keeps them as its state) and the SGD update made
    from them as ``optax.sgd`` makes it (p + (-lr * g) in f32), per mode
    (its device mode stands for both topological modes: JAX's host modes
    build the JAX package's native library with make)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "indices"}
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, params=None: (jax.tree.map(jnp.zeros_like, g), g))

    def hf(dec):
        sd = params_from_jax(jax.tree.map(np.asarray, {**tree,
                                                         "decoder": dec}))
        return {k: v.numpy() for k, v in sd.items()
                if k.startswith("mask_decoder.")}

    out = {}
    for mode, kw in MODES.items():
        if kw:
            kw = dict(kw, topo_device=True)
        conf = jtr.TrainConfig(compute_dtype="float32", learning_rate=LR,
                               **kw)
        dec, frozen = jtr._split_params(jax.tree.map(jnp.asarray, tree))
        before = {k: v.copy() for k, v in hf(dec).items()}  # dec is donated
        out[f"{mode}/eval_loss"] = np.asarray(
            jtr.make_eval_step(cfg, conf, ORIG_HW, True)(dec, frozen, jb))
        step = jtr.make_train_step(cfg, conf, keep_grads, ORIG_HW, True)
        _, grads, loss = step(dec, keep_grads.init(dec), frozen, jb)
        out[f"{mode}/loss"] = np.asarray(loss)
        for k, g in hf(grads).items():
            out[f"{mode}/grad/{k}"] = g
            out[f"{mode}/param/{k}"] = before[k] + np.float32(-LR) * g
    return out


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """The two ranks' results, the port's single-process results and JAX's
    on the same padded batch."""
    d = tmp_path_factory.mktemp("dp")
    cfg, tree, batch = _case_inputs()
    sd = {k: v.numpy() for k, v in params_from_jax(tree).items()}
    np.savez(d / "in.npz", **{f"p:{k}": v for k, v in sd.items()},
             **{f"b:{k}": v for k, v in batch.items()})
    run_pair("steps", str(d / "in.npz"), str(d / "out{rank}.npz"))
    ranks = [dict(np.load(d / f"out{r}.npz")) for r in (0, 1)]
    return ranks, step_results(sd, batch), _jax_results(cfg, tree, batch)


def _assert_close(got, want, what):
    for key in want:
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key])
        atol = max(RTOL * float(np.abs(w).max()), 1e-8) if w.ndim else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                   err_msg=f"{what}: {key}")


def _of(results, mode):
    return {k: v for k, v in results.items() if k.startswith(mode + "/")}


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_hold_the_same_state(dp_case, mode):
    """After the all-reduce both ranks hold the same loss, gradients and
    parameters, bit for bit."""
    r0, r1 = dp_case[0]
    for k in _of(r0, mode):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_step_matches_single_process(dp_case, mode):
    """Loss, eval loss, every gradient and every updated parameter of the
    two-rank step against the port's step on the whole padded batch."""
    ranks, single, _ = dp_case
    _assert_close(_of(ranks[0], mode), _of(single, mode), "2 ranks vs 1")


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_step_matches_jax(dp_case, mode):
    """The same against JAX's ``make_train_step`` / ``make_eval_step`` on
    the padded batch (the sharded step's single-device equivalent)."""
    ranks, _, want = dp_case
    _assert_close(_of(ranks[0], mode), _of(want, mode), "2 ranks vs JAX")
