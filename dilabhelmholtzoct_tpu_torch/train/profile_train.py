"""Where the training-step time goes on the card, at SAM ViT-B (bf16).

    python -m dilabhelmholtzoct_tpu_torch.train.profile_train [--top 15]

Builds the cached-embedding train step of ``train/trainer.py`` on the seeded
workload (``inference/synthetic.py``: random ViT-B weights, 8 synthetic OCT
items of 8 components, so one batch is 8 images x bucket 8 = 64 (image,
prompt) pairs), precomputes their embeddings, runs three warm-up steps and
then five steps under ``torch.profiler``. It prints the card's name and power
limit, the host wall time, the device time summed over kernels and copies,
the busy share, the device time by kind (K3, K4, matrix products, copies,
other kernels) and the top kernels. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..data.pipeline import PromptedDataset, batches
from ..inference import synthetic
from ..inference.profile_serving import profile_window
from ..models.configs import sam_vit_base
from . import trainer as tr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=15,
                        help="kernels listed per window")
    parser.add_argument("--steps", type=int, default=5,
                        help="train steps inside the profiled window")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda")
    cfg = sam_vit_base()
    sd = {k: v.to(dev) for k, v in synthetic.random_params(cfg).items()}
    ds = PromptedDataset(synthetic.oct_training_items(8, seed=1), seed=0)
    config = tr.TrainConfig(evaluate=False, batch_size=8)
    emb = tr.precompute_embeddings(sd, cfg, ds, dtype=torch.bfloat16)
    batch = list(batches(ds, 8, with_images=False, num_workers=2))[0]
    db = {k: torch.as_tensor(batch[k]).to(dev)
          for k in ("prompts", "comp_map", "channel_mask")}
    db["embeddings"] = emb
    decoder, frozen = tr._split_params(sd)
    for v in decoder.values():
        v.requires_grad_(True)
    opt = tr.make_optimizer(config, decoder.values())
    step = tr.make_train_step(cfg, config, opt, (496, 512), True)
    for _ in range(3):
        step(decoder, opt, frozen, db)
    profile_window(f"train step bf16, 8 images x bucket 8, x{args.steps}",
                   lambda: step(decoder, opt, frozen, db), args.steps,
                   args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
