"""Where the training time goes on the card, at SAM ViT-B (bf16) or another
preset (``--base_model facebook/sam-vit-huge``: every encoder layer on K6).

    python -m dilabhelmholtzoct_tpu_torch.train.profile_train [--top 15]
    python -m dilabhelmholtzoct_tpu_torch.train.profile_train --trainable all
    python -m dilabhelmholtzoct_tpu_torch.train.profile_train --trainable all \
        --compute_dtype float32
    python -m dilabhelmholtzoct_tpu_torch.train.profile_train --precompute \
        [--base_model facebook/sam-vit-huge]
    python -m dilabhelmholtzoct_tpu_torch.train.profile_train --uncached

Builds a train step of ``train/trainer.py`` on the seeded workload
(``inference/synthetic.py``: random ViT-B weights, synthetic OCT items of 8
components each), runs three warm-up steps and then ``--steps`` steps under
``torch.profiler``:

  * ``--trainable decoder`` (the default): the cached-embedding decoder
    step on 8 images x bucket 8 = 64 (image, prompt) pairs, after the
    embedding precompute;
  * ``--trainable all``: the full fine-tune step as ``chip_smoke.py`` runs
    it (BASELINE config 5 geometry): 4 images x bucket 8, the encoder
    inside the gradient with every layer checkpointed;
  * ``--uncached``: the decoder step with the frozen encoder inside it
    (``cache_embeddings=False``, the path of ``data_transforms``) on 4
    images x bucket 8, as ``chip_smoke.py``'s data path runs it;
  * ``--compute_dtype float32`` (with either ``--trainable``): the step in
    f32 (the encoder attention's K1 / K2 / K5 in split TF32 on the tensor
    cores; the decoder's plain route) instead of bf16;
  * ``--precompute``: instead of steps, one bf16 embedding precompute of
    the 8 images (the frozen encoder of decoder fine-tuning) after a first
    one outside the window.

It prints the card's name and power limit, the host wall time, the device
time summed over kernels and copies, the busy share, the device time by
kind (K1-K5, matrix products, copies, other kernels) and the top kernels.
Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..data.pipeline import PromptedDataset, batches
from ..inference import synthetic
from ..inference.profile_serving import profile_window
from ..models.configs import config_for
from . import trainer as tr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=15,
                        help="kernels listed per window")
    parser.add_argument("--steps", type=int, default=5,
                        help="train steps inside the profiled window")
    parser.add_argument("--trainable", choices=["decoder", "all"],
                        default="decoder",
                        help="'all': the full fine-tune step (encoder "
                             "inside, 4 images); 'decoder': the cached-"
                             "embedding decoder step (8 images)")
    parser.add_argument("--base_model", type=str,
                        default="facebook/sam-vit-base")
    parser.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                        default="bfloat16",
                        help="the train step's compute dtype (the precompute "
                             "stays bf16)")
    parser.add_argument("--uncached", action="store_true",
                        help="the decoder step with the frozen encoder "
                             "inside (4 images, cache_embeddings=False)")
    parser.add_argument("--precompute", action="store_true",
                        help="profile the bf16 embedding precompute of the 8 "
                             "images instead of train steps")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}; {args.base_model}")
    dev = torch.device("cuda")
    cfg = config_for(args.base_model)
    sd = {k: v.to(dev) for k, v in synthetic.random_params(cfg).items()}
    if args.precompute:
        ds = PromptedDataset(synthetic.oct_training_items(8, seed=1), seed=0)
        tr.precompute_embeddings(sd, cfg, ds, dtype=torch.bfloat16)
        profile_window("embedding precompute bf16, 8 images",
                       lambda: tr.precompute_embeddings(
                           sd, cfg, ds, dtype=torch.bfloat16, verbose=False),
                       1, args.top)
        return 0
    full = args.trainable == "all"
    with_images = full or args.uncached
    bs = 4 if with_images else 8
    ds = PromptedDataset(synthetic.oct_training_items(bs, seed=1), seed=0)
    config = tr.TrainConfig(evaluate=False, batch_size=bs,
                            trainable=args.trainable,
                            cache_embeddings=not with_images,
                            compute_dtype=args.compute_dtype)
    batch = list(batches(ds, bs, with_images=with_images, num_workers=2))[0]
    db = {k: torch.as_tensor(batch[k]).to(dev)
          for k in ("prompts", "comp_map", "channel_mask")}
    if with_images:
        db["image"] = torch.as_tensor(batch["image"]).to(dev)
    else:
        db["embeddings"] = tr.precompute_embeddings(sd, cfg, ds,
                                                    dtype=torch.bfloat16)
    params, frozen = tr._split_params(sd, args.trainable)
    for v in params.values():
        v.requires_grad_(True)
    opt = tr.make_optimizer(config, params.values())
    step = tr.make_train_step(cfg, config, opt, (496, 512), not with_images)
    for _ in range(3):
        step(params, opt, frozen, db)
    tname = "bf16" if args.compute_dtype == "bfloat16" else "f32"
    what = (f"full fine-tune step {tname}, 4 images x bucket 8" if full
            else f"uncached train step {tname}, 4 images x bucket 8"
            if args.uncached else f"train step {tname}, 8 images x bucket 8")
    profile_window(f"{what}, x{args.steps}",
                   lambda: step(params, opt, frozen, db), args.steps,
                   args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
