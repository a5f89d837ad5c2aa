"""Training CLI of the PyTorch port, with the reference's flag surface.

Port of ``dilabhelmholtzoct_tpu/train/cli.py``: the same flags build the
same ``TrainConfig``, and training runs on the card and ends, unless
``--evaluate false``, with the evaluation report on the test split.
Data parallelism runs one process per card: ``torchrun --nproc_per_node N
-m dilabhelmholtzoct_tpu_torch.train.cli ...`` (``data_parallel`` is on by
default; ``--multihost true`` asks for the group explicitly and warns when
the env names none). The dataset comes from ``python -m
dilabhelmholtzoct_tpu_torch.data.preprocessing``. Without the ``datasets``
package, call
``train.trainer.training(config, splits=...)`` from Python instead.

Flag-name parity with octsam/models/training.py:20-93 (``--base_model
--loss --dataset --data_directory --dataset_name --lr --weight_decay
--epochs --bs --shuffle --optimizer --display_mode --display_idx
--display_val_nr --display_train_nr --mode --seg_nr --pseudocolor
--display_name --evaluate --prompt --top``) plus wandb args and the JAX
package's additions. Boolean flags parse properly (the reference's ``type=bool``
truthiness bug, training.py:42,87, is documented and not replicated).

Usage:
    python -m dilabhelmholtzoct_tpu_torch.train.cli \
        --data_directory /vol/data --dataset_name my_preprocessed_at_...
"""

from __future__ import annotations

import argparse
import os

from ..data.store import timestamp
from ..ops.preprocess import COLORMAP_NAMES
from ..utils.flags import str2bool as _str2bool  # shared strict parser
from .trainer import TrainConfig, training

# 14-class custom OCT label names (training.py:146-163)
CUSTOM_MASK_DICT = {
    0: "background",
    1: "epiretinal membrane",
    2: "neurosensory retina",
    3: "intraretinal fluid",
    4: "subretinal fluid",
    5: "subretinal hyperreflective material",
    6: "retinal pigment epithelium",
    7: "pigment epithelial detachment",
    8: "posterior hyaloid membrane",
    9: "choroid border",
    10: "imaging artifacts",
    11: "fibrosis",
    12: "vitreous body",
    13: "image padding",
}

MODES = ("single_mask", "all_masks_one_model", "all_masks_seperate_models")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # W&B parameters
    p.add_argument("--project_name", type=str, default="OCT-TPU-experiments")
    p.add_argument("--entity", type=str, default=None)
    p.add_argument("--wandb", type=_str2bool, default=False)
    # Model info
    p.add_argument("--base_model", type=str, default="facebook/sam-vit-base")
    p.add_argument("--loss", type=str, default="diceCE")
    p.add_argument("--pretrained_checkpoint", type=str, default=None,
                   help="local HF SAM .pt/.safetensors (offline replacement "
                        "for from_pretrained downloads)")
    # Dataset
    p.add_argument("--dataset", type=str, default="custom")
    p.add_argument("--data_directory", type=str, default="/vol/data")
    p.add_argument("--dataset_name", type=str, default="")
    # Training parameters
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--bs", type=int, default=2)
    p.add_argument("--shuffle", type=_str2bool, default=False)
    p.add_argument("--optimizer", type=str, default="adam")
    # Display
    p.add_argument("--display_mode", type=str, default="none",
                   choices=["none", "predefined", "random_equal",
                            "random_changing"])
    p.add_argument("--display_idx", type=str, default="0, 1, 3")
    p.add_argument("--display_val_nr", type=int, default=1)
    p.add_argument("--display_train_nr", type=int, default=1)
    # Modes (kept for flag parity; mode 1 = all_masks_one_model is what the
    # reference actually implements)
    p.add_argument("--mode", type=int, default=1)
    p.add_argument("--seg_nr", type=int, default=3)
    # Pseudocolor
    p.add_argument("--pseudocolor", type=str, default="grayscale",
                   choices=list(COLORMAP_NAMES))
    p.add_argument("--display_name", type=str, default="")
    p.add_argument("--evaluate", type=_str2bool, default=True)
    p.add_argument("--eval_device", type=str, default="default",
                   choices=["default", "cpu"],
                   help="'cpu' replicates the reference's eval-on-CPU "
                        "placement (training_utils.py:83-85)")
    p.add_argument("--prompt", type=str, default="bboxes",
                   choices=["bboxes", "points"])
    p.add_argument("--top", action="store_true",
                   help="add the topological loss (cubical persistence + "
                        "Wasserstein, lambda 0.1, 50x50 grids, H1)")
    # knobs beyond the reference's flags
    p.add_argument("--cache_embeddings", type=_str2bool, default=True)
    p.add_argument("--data_transforms", type=str, default="",
                   help="comma list of augment ops (hflip,vflip,brightness,"
                        "contrast,gaussian_noise,shift); working equivalent "
                        "of the reference's dormant albumentations hook")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--trainable", type=str, default="decoder",
                   choices=["decoder", "all"],
                   help="'all' = full fine-tune incl. the image and prompt "
                        "encoders: every encoder layer checkpointed, the "
                        "attention backward on the K5 kernel; implies "
                        "--cache_embeddings false")
    p.add_argument("--topo_pipeline", type=_str2bool, default=True,
                   help="with --topo_device false: pair on the host behind "
                        "a one-batch delay (the pairing one update stale); "
                        "false = synchronous host pairing")
    p.add_argument("--topo_device", type=_str2bool, default=True,
                   help="pair and match on the card inside the step "
                        "(kernels T1 / T2); false = on the host (the C++ "
                        "library, --topo_pipeline picks pipelined or sync)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=_str2bool, default=False)
    p.add_argument("--multihost", type=_str2bool, default=False,
                   help="join the torch.distributed group for multi-process "
                        "DP (coordinator via MASTER_ADDR / MASTER_PORT / "
                        "WORLD_SIZE / RANK, as torchrun sets them)")
    return p


def config_from_args(args) -> TrainConfig:
    t = timestamp()
    data_path = os.path.join(
        args.data_directory, "datasets", "processed", args.dataset,
        args.dataset_name,
    )
    model_path = os.path.join(args.data_directory, "models", args.dataset)
    if args.display_name:
        display_name = args.display_name
    else:
        display_name = (
            f"{args.lr:.0e} lr,{args.weight_decay:.0e} wd,{args.bs} bs, "
            f"{args.loss} loss, {args.pseudocolor}, {t}"
        )
    return TrainConfig(
        base_model=args.base_model,
        dataset=data_path,
        checkpoint=model_path,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        batch_size=args.bs,
        shuffle=args.shuffle,
        optimizer=args.optimizer,
        loss=args.loss,
        prompt_type=args.prompt,
        pseudocolor=(None if args.pseudocolor == "grayscale"
                     else args.pseudocolor),
        topological=args.top,
        topo_pipeline=args.topo_pipeline,
        topo_device=args.topo_device,
        evaluate=args.evaluate,
        eval_device=args.eval_device,
        display_name=display_name,
        time=t,
        display_mode=args.display_mode,
        display_idx=tuple(
            int(x) for x in args.display_idx.strip().split(",") if x.strip()
        ),
        display_train_nr=args.display_train_nr,
        display_val_nr=args.display_val_nr,
        mask_dict=dict(CUSTOM_MASK_DICT) if args.dataset == "custom" else {},
        pretrained_checkpoint=args.pretrained_checkpoint,
        cache_embeddings=(args.cache_embeddings
                          and not args.data_transforms
                          and args.trainable == "decoder"),
        data_transforms=tuple(
            x.strip() for x in args.data_transforms.split(",") if x.strip()
        ),
        compute_dtype=args.compute_dtype,
        trainable=args.trainable,
        seed=args.seed,
        resume=args.resume,
        use_wandb=args.wandb,
        project_name=args.project_name,
        entity=args.entity,
        wandb_dir=os.path.join(args.data_directory, "runs"),
        export_pt=True,  # reference parity: final .pt always written
        multihost=args.multihost,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    print("CONFIG:", config)
    return training(config)


if __name__ == "__main__":
    main()
