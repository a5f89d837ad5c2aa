"""One rank of the port's two-rank data-parallel CPU tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_train_dp.py`` start
two of these as processes that join one gloo group on a free localhost
port; the tests call the same functions in their own process, with no
group, for the single-process numbers:

    python tests/torch_dp_worker.py steps <rank> <port> <in.npz> <out.npz>
    python tests/torch_dp_worker.py training <rank> <port> <root> <out.json>

``steps``: the port's train step (SGD, so the update is the gradient's)
and eval step at ``sam_tiny`` f32 from cached embeddings, in each of
``MODES``, on this rank's rows of the padded batch in ``in.npz``.
``training``: ``training()`` for 2 epochs on ``train_items`` with
``multihost=True`` (the env names the group, as ``torchrun`` sets it), then
resumed to 3 with ``data_parallel`` alone; the histories and what the rank
wrote.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dilabhelmholtzoct_tpu_torch.models import configs  # noqa: E402
from dilabhelmholtzoct_tpu_torch.parallel import distributed as dist  # noqa: E402
from dilabhelmholtzoct_tpu_torch.parallel import mesh  # noqa: E402
from dilabhelmholtzoct_tpu_torch.train import trainer as tr  # noqa: E402

ORIG_HW = (48, 64)
LR = 1e-2
TOPO = dict(topological=True, topo_interp=16)
MODES = {
    "plain": {},
    "topo_device": dict(TOPO, topo_device=True),
    "host_sync": dict(TOPO, topo_device=False, topo_pipeline=False),
}

configs.register_preset("tiny-test", lambda: configs.sam_tiny(128))


def step_results(sd_np: dict, batch: dict) -> dict:
    """For each mode, from the parameters ``sd_np`` (HF names, numpy): the
    eval step's loss, then one train step's loss, every decoder gradient
    and every updated decoder tensor, as numpy under "<mode>/..."."""
    cfg = configs.sam_tiny(128)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = {}
    for mode, kw in MODES.items():
        conf = tr.TrainConfig(compute_dtype="float32", optimizer="sgd",
                              learning_rate=LR, evaluate=False, **kw)
        dec, frozen = tr._split_params(
            {k: torch.tensor(v) for k, v in sd_np.items()})
        for v in dec.values():
            v.requires_grad_(True)
        opt = tr.make_optimizer(conf, dec.values())
        estep = tr.make_eval_step(cfg, conf, ORIG_HW, True)
        step = tr.make_train_step(cfg, conf, opt, ORIG_HW, True)
        for s in (estep, step):
            if hasattr(s, "set_host_batch"):
                s.set_host_batch(batch)
        out[f"{mode}/eval_loss"] = estep(dec, frozen, tb).numpy()
        dec, opt, loss = step(dec, opt, frozen, tb)
        out[f"{mode}/loss"] = loss.numpy()
        for k, v in dec.items():
            out[f"{mode}/grad/{k}"] = v.grad.numpy()
            out[f"{mode}/param/{k}"] = v.detach().numpy()
    return out


def train_items(n: int, seed: int) -> list:
    """``n`` items of 48 x 64 noise with 3 labelled blocks each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = np.zeros(ORIG_HW, np.uint8)
        for c in range(1, 4):
            y, x = int(rng.integers(2, 30)), int(rng.integers(2, 44))
            lab[y:y + 14, x:x + 18] = c
        out.append({"image": rng.integers(0, 255, (*ORIG_HW, 3),
                                          dtype=np.uint8), "label": lab})
    return out


def train_config(root: str, **kw) -> tr.TrainConfig:
    """Batches of 3 (padded to 4 for two ranks), 6 + 3 items, f32."""
    base = dict(base_model="tiny-test", checkpoint=root, learning_rate=3e-2,
                epochs=2, batch_size=3, evaluate=False,
                compute_dtype="float32", buckets=(4, 8), display_name="run",
                time="t0", ckpt_keep=2, shuffle=True, export_pt=True)
    base.update(kw)
    return tr.TrainConfig(**base)


def training_results(root: str, **kw) -> dict:
    """2 epochs, then resumed to 3: both histories, and the checkpoint
    saves and exports this process made."""
    calls = {"save": 0, "export": 0}
    save, export = tr.ckpt_utils.save_checkpoint, \
        tr.ckpt_utils.export_reference_pt

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    tr.ckpt_utils.save_checkpoint = counted("save", save)
    tr.ckpt_utils.export_reference_pt = counted("export", export)
    try:
        splits = (train_items(6, 0), train_items(3, 1))
        first = tr.training(train_config(root, **kw), splits=splits,
                            device="cpu")
        resumed = tr.training(
            train_config(root, epochs=3, resume=True, export_pt=False),
            splits=splits, device="cpu")
    finally:
        tr.ckpt_utils.save_checkpoint = save
        tr.ckpt_utils.export_reference_pt = export
    return {"history": first["history"], "resumed": resumed["history"],
            **calls}


def run_pair(task: str, *args: str, timeout: float = 300) -> None:
    """Run ``task`` as ranks 0 and 1 of one gloo group on a free localhost
    port, in two processes; raises with a rank's output if it fails."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(rank), port,
         *[a.format(rank=rank) for a in args]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DP_WORKER_OK {rank}" not in out:
            raise RuntimeError(f"rank {rank} failed (rc {p.returncode}):\n"
                               f"{out}")


def main(argv) -> None:
    task, rank, port = argv[0], int(argv[1]), argv[2]
    if task == "steps":
        src, dst = argv[3], argv[4]
        assert dist.initialize(f"localhost:{port}", 2, rank,
                               backend="gloo") is True
        assert dist.initialize() is True  # a second call: the same group
        data = np.load(src)
        sd = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
        batch = {k[2:]: data[k] for k in data.files if k.startswith("b:")}
        np.savez(dst, **step_results(sd, mesh.shard_batch(batch)))
    else:
        root, dst = argv[3], argv[4]
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                          WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0")
        out = training_results(root, multihost=True)
        with open(dst, "w") as f:
            json.dump(out, f)
    dist.shutdown()
    print(f"DP_WORKER_OK {rank}")


if __name__ == "__main__":
    main(sys.argv[1:])
