"""Standalone evaluation CLI.

Port of ``dilabhelmholtzoct_tpu/eval/cli.py`` with its flags: evaluates any
checkpoint directly (the reference can only evaluate as the tail of a
training run), on the card unless ``--eval_device cpu`` or ``--device cpu``
asks for the host.

    python -m dilabhelmholtzoct_tpu_torch.eval.cli \
        --data_directory /vol/data --dataset_name default_preprocessed_at_... \
        --checkpoint /vol/data/models/custom/<run>.pt [--prompt bboxes]

Reading the saved dataset needs the ``datasets`` package; without it call
``eval.harness.evaluate_metrics`` on in-memory items from Python.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.pipeline import PromptedDataset
from ..data.store import load_split
from ..train.cli import CUSTOM_MASK_DICT
from ..train.trainer import TrainConfig, prepare_model
from .harness import evaluate_metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_model", type=str, default="facebook/sam-vit-base")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="fine-tuned .pt/.pth/.safetensors (local)")
    p.add_argument("--dataset", type=str, default="custom")
    p.add_argument("--data_directory", type=str, default="/vol/data")
    p.add_argument("--dataset_name", type=str, default="")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--prompt", type=str, default="bboxes",
                   choices=["bboxes", "points"])
    p.add_argument("--pseudocolor", type=str, default="grayscale")
    p.add_argument("--eval_device", type=str, default="default",
                   choices=["default", "cpu"],
                   help="'cpu' replicates the reference's eval-on-CPU "
                        "placement (training_utils.py:83-85: the eval "
                        "model never moves to the accelerator)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_json", type=str, default=None,
                   help="also write the metric report as JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="where 'default' runs: 'cuda' (default) or 'cpu'")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        base_model=args.base_model,
        pretrained_checkpoint=args.checkpoint,
        prompt_type=args.prompt,
        pseudocolor=(None if args.pseudocolor == "grayscale"
                     else args.pseudocolor),
        mask_dict=dict(CUSTOM_MASK_DICT) if args.dataset == "custom" else {},
        seed=args.seed,
        eval_device=args.eval_device,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    data_path = os.path.join(
        args.data_directory, "datasets", "processed", args.dataset,
        args.dataset_name,
    )
    config = config_from_args(args)
    cfg, params = prepare_model(config)
    ds = PromptedDataset(
        load_split(data_path, args.split),
        prompt_type=args.prompt,
        pseudocolor=config.pseudocolor,
        seed=args.seed,
    )
    if len(ds) == 0:
        raise SystemExit(
            f"[eval] split {args.split!r} of {data_path} is empty — "
            "nothing to evaluate (check --dataset_name/--split)"
        )
    # shape only: skips the full prompt-sampling pass ds[0] would run
    orig_hw = ds.image(0).shape[:2]
    report = evaluate_metrics(params, cfg, config, ds, orig_hw=orig_hw,
                              device=args.device)
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=1, default=float)
        print(f"[eval] report written to {args.report_json}")
    return report


if __name__ == "__main__":
    main()
