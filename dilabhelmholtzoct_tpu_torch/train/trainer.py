"""Fine-tuning of SAM on the card: MedSAM-style (the mask decoder) or the
whole model.

Port of ``dilabhelmholtzoct_tpu/train/trainer.py``: Adam on the trainable
entries — ``trainable='decoder'`` (the reference's scope, the
``mask_decoder.*`` parameters, with frozen image and prompt encoders) or
``trainable='all'`` (every parameter, encoders included) — DiceCE loss on
the postprocessed masks, per-epoch train/validation losses with the
reference's metric names, per-epoch checkpoints with retention and resume,
and the reference's ``.pt`` export.

Mixed precision as the JAX package's ``_cast_floats``: the trainable master
weights are f32 leaf tensors with ``requires_grad``; every float parameter,
frozen ones included, is cast to the compute dtype inside the forward, so
the gradients arrive back in f32. The casts are explicit (no autocast,
which would move the rounding points). In bf16 the decoder runs through the
hand-written kernels K3 (upscaler) and K4 (image->token attention), forward
and backward; the encoder's attention runs K1 / K2, and with
``trainable='all'`` their backward K5.

With ``cache_embeddings`` (the default) the frozen encoder runs once per
image before the first epoch (``precompute_embeddings``) and each step
starts from the cached embeddings; otherwise the encoder runs inside every
step: under ``torch.no_grad()`` (JAX's ``stop_gradient``) for the decoder
fine-tune, inside the gradient with every layer checkpointed for
``trainable='all'`` (which needs ``cache_embeddings=False``).

With ``evaluate`` (the default, as in JAX) the run ends with the per-class
report of ``eval/harness.py`` on the validation set, returned as
``metrics``.

Not in this slice (each raises ``NotImplementedError``): the topological
loss, sample display, augmentation (``data_transforms``), multi-host / data
parallelism and profiler traces. With one card ``data_parallel`` is a no-op,
as in JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.pipeline import PromptedDataset, batches
from ..data.sampling import DEFAULT_BUCKETS, gt_masks_from_comp_map
from ..data.store import load_split
from ..device import full_fp32, resolve_device
from ..models.configs import SamConfig, config_for
from ..models.sam import (
    decode_masks,
    encode_image,
    encode_image_microbatched,
    encode_prompts,
    image_wide_pe,
    init_params,
)
from ..ops.losses import segmentation_loss
from ..ops.postprocess import postprocess_masks_blocked
from ..ops.preprocess import preprocess_image, rescale_boxes, rescale_coords
from ..utils import checkpoint as ckpt_utils
from ..utils.logging import MultiLogger, make_logger
from ..utils.profiling import StepTimer

DECODER_PREFIX = "mask_decoder."


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``: the reference's flag surface plus
    the same extra knobs, with the same defaults."""

    base_model: str = "facebook/sam-vit-base"
    dataset: str = ""  # path to a saved DatasetDict
    checkpoint: str = "checkpoints"  # output dir
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 10
    batch_size: int = 2
    shuffle: bool = False
    optimizer: str = "adam"
    loss: str = "diceCE"
    prompt_type: str = "bboxes"
    pseudocolor: str | None = None
    topological: bool = False
    evaluate: bool = True
    eval_device: str = "default"
    display_name: str = "run"
    time: str = ""
    display_mode: str = "none"
    display_idx: tuple[int, ...] = (0, 1, 3)
    display_train_nr: int = 1
    display_val_nr: int = 1
    mask_dict: dict[int, str] = field(default_factory=dict)
    pretrained_checkpoint: str | None = None  # HF .pt/.safetensors on disk
    cache_embeddings: bool = True
    compute_dtype: str = "bfloat16"
    ckpt_keep: int = 3  # newest per-epoch checkpoints retained (0 = all)
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    seed: int = 0
    resume: bool = False
    log_jsonl: str | None = None
    use_wandb: bool = False
    project_name: str = "OCT-TPU-experiments"
    entity: str | None = None
    wandb_dir: str | None = None
    topo_lamda: float = 0.1
    topo_feat_d: int = 1
    topo_interp: int = 50
    topo_pipeline: bool = True
    topo_device: bool = True
    topo_true_cache: bool = True
    export_pt: bool = False  # write the reference-format .pt at the end
    encoder_microbatch: int = 1  # images encoded per sequential chunk
    data_transforms: tuple[str, ...] = ()
    data_parallel: bool = True
    multihost: bool = False
    trainable: str = "decoder"  # "decoder" (reference parity) | "all"
    profile_dir: str | None = None


def _check_supported(config: TrainConfig, *, loop: bool = True) -> None:
    """Raise for the parts of the JAX training path that later slices port;
    ``loop=False`` checks only what a train step itself runs."""
    if config.trainable not in ("decoder", "all"):
        raise ValueError(f"unknown trainable {config.trainable!r}")
    later = [(config.topological, "topological=True (the topological loss)")]
    if loop:
        later += [
            (config.display_mode != "none",
             "display_mode != 'none' (display)"),
            (bool(config.data_transforms), "data_transforms (augmentation)"),
            (config.multihost, "multihost (data parallelism)"),
            (bool(config.profile_dir), "profile_dir (training traces)"),
        ]
    for on, what in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet: a later slice of the "
                "port; pass it off")
    if loop and config.trainable == "all" and config.cache_embeddings:
        raise ValueError(
            "trainable='all' requires cache_embeddings=False (the encoder "
            "trains, so its outputs change every step)")


def _dtype(config: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def prepare_model(config: TrainConfig) -> tuple[SamConfig, dict]:
    """Model config and an f32 HF-named state_dict on the host: the local
    checkpoint when ``pretrained_checkpoint`` is given, else random
    parameters from ``config.seed`` (the JAX package's scales; other numbers
    than JAX's for the same seed)."""
    cfg = config_for(config.base_model)
    if config.pretrained_checkpoint:
        from ..models.convert import load_state_dict

        return cfg, load_state_dict(config.pretrained_checkpoint)
    return cfg, init_params(cfg, torch.Generator().manual_seed(config.seed))


def _split_params(sd: dict, trainable: str = "decoder") -> tuple[dict, dict]:
    """(trainable entries, frozen rest): "decoder" trains every
    ``mask_decoder.*`` entry, the reference's optimizer scope
    ``model.mask_decoder.parameters()``; "all" trains every entry."""
    if trainable == "all":
        return dict(sd), {}
    decoder = {k: v for k, v in sd.items() if k.startswith(DECODER_PREFIX)}
    frozen = {k: v for k, v in sd.items() if not k.startswith(DECODER_PREFIX)}
    return decoder, frozen


def _merge_params(decoder: dict, frozen: dict) -> dict:
    return {**frozen, **decoder}


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """torch ``Adam(lr, weight_decay)``: the L2 term added to the gradient
    before the moments, eps 1e-8 — exactly optax's ``add_decayed_weights ->
    adam`` of the JAX package. 'adamw' maps to ``AdamW`` (decoupled decay),
    'sgd' to ``SGD``."""
    opt = config.optimizer.lower()
    params = list(params)
    if opt == "adam":
        return torch.optim.Adam(params, lr=config.learning_rate,
                                weight_decay=config.weight_decay)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=config.learning_rate,
                                 weight_decay=config.weight_decay)
    if opt == "sgd":
        return torch.optim.SGD(params, lr=config.learning_rate,
                               weight_decay=config.weight_decay)
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def _cast_floats(sd: dict, dtype) -> dict:
    """Every float entry cast to the compute dtype (identity for f32). On a
    leaf with ``requires_grad`` the cast is part of the graph, so its
    gradient comes back in f32."""
    if dtype == torch.float32:
        return sd
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in sd.items()}


def _forward_from_embeddings(decoder, frozen, cfg: SamConfig, embeddings,
                             batch, orig_hw, prompt_type: str):
    """Prompt-encode -> decode (blocked) -> postprocess -> (B, C, H, W)
    f32 logits."""
    sd = _merge_params(decoder, frozen)
    b = embeddings.shape[0]
    size = cfg.vision.image_size
    if prompt_type == "points":
        pts = rescale_coords(batch["prompts"], orig_hw, size)
        sparse, dense = encode_prompts(sd, cfg, b, points=pts,
                                       labels=batch["point_labels"],
                                       dtype=embeddings.dtype)
    else:
        boxes = rescale_boxes(batch["prompts"], orig_hw, size)
        sparse, dense = encode_prompts(sd, cfg, b, boxes=boxes,
                                       dtype=embeddings.dtype)
    pe = image_wide_pe(sd, cfg)
    low_res, _ = decode_masks(sd, cfg, embeddings, pe, sparse, dense,
                              multimask_output=False, blocked=True)
    return postprocess_masks_blocked(low_res[:, :, 0], orig_hw,
                                     model_size=size)


def _loss_from_masks(masks, batch, config: TrainConfig):
    """DiceCE (or one of its parts) against the component masks."""
    gt = gt_masks_from_comp_map(batch["comp_map"], masks.shape[1])
    return segmentation_loss(config.loss)(masks, gt, batch["channel_mask"])


def _prompt_entries(frozen: dict) -> dict:
    """The frozen entries a forward from embeddings reads (all but the
    image encoder)."""
    return {k: v for k, v in frozen.items()
            if not k.startswith("vision_encoder.")}


def _encode(sd, cfg, images, dtype, microbatch):
    """uint8 (B, H, W, 3) on the card -> (B, G, G, C) embeddings in dtype,
    without gradients (the encoder is frozen)."""
    with torch.no_grad():
        pix, _ = preprocess_image(images, target_size=cfg.vision.image_size,
                                  dtype=dtype)
        return encode_image_microbatched(sd, pix, cfg, microbatch).to(dtype)


def _zero_missing_grads(optimizer) -> None:
    """A zero gradient for every optimized tensor the loss did not reach
    (the iou head, prompt embeddings of unused labels): torch's optimizers
    skip a ``None`` gradient, optax gets a dense zero one, which weight
    decay still moves."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(cfg: SamConfig, config: TrainConfig, optimizer,
                    orig_hw: tuple[int, int], from_embeddings: bool):
    """The train step ``step(params, optimizer, frozen, batch) ->
    (params, optimizer, loss)``: forward, DiceCE, backward and one
    optimizer update of the trainable tensors ``params`` (in place; they are
    the tensors ``optimizer`` holds). ``loss`` is a detached 0-d tensor on
    the card, so the caller syncs once per epoch, not per step.

    from_embeddings=True: ``batch["embeddings"]`` holds cached encoder
    outputs. False: ``batch["image"]`` holds uint8 images and the encoder
    runs inside the step — frozen, under ``torch.no_grad()``, for
    ``trainable='decoder'``; inside the gradient, from the same cast
    parameters as the decoder, every layer checkpointed and without
    microbatching, for ``trainable='all'`` (the JAX step)."""
    _check_supported(config, loop=False)
    dtype = _dtype(config)
    train_encoder = config.trainable == "all"

    def step(params, optimizer, frozen, batch):
        with full_fp32():
            params_c = _cast_floats(params, dtype)
            if from_embeddings:
                embeddings = batch["embeddings"].to(dtype)
                frozen_c = _cast_floats(_prompt_entries(frozen), dtype)
            else:
                frozen_c = _cast_floats(frozen, dtype)
                if train_encoder:
                    pix, _ = preprocess_image(
                        batch["image"], target_size=cfg.vision.image_size,
                        dtype=dtype)
                    embeddings = encode_image(
                        _merge_params(params_c, frozen_c), pix, cfg,
                        remat=True)
                else:
                    embeddings = _encode(frozen_c, cfg, batch["image"], dtype,
                                         config.encoder_microbatch)
            masks = _forward_from_embeddings(
                params_c, frozen_c, cfg, embeddings, batch, orig_hw,
                config.prompt_type)
            loss = _loss_from_masks(masks, batch, config)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            _zero_missing_grads(optimizer)
            optimizer.step()
        return params, optimizer, loss.detach()

    return step


def make_eval_step(cfg: SamConfig, config: TrainConfig, orig_hw,
                   from_embeddings: bool):
    """``step(decoder, frozen, batch) -> loss``: the train step's forward and
    loss, in the same compute dtype, without gradients."""
    dtype = _dtype(config)

    @torch.no_grad()
    def step(decoder, frozen, batch):
        with full_fp32():
            dec_c = _cast_floats(decoder, dtype)
            if from_embeddings:
                embeddings = batch["embeddings"].to(dtype)
                frozen_c = _cast_floats(_prompt_entries(frozen), dtype)
            else:
                frozen_c = _cast_floats(frozen, dtype)
                embeddings = _encode(_merge_params(dec_c, frozen_c), cfg,
                                     batch["image"], dtype,
                                     config.encoder_microbatch)
            masks = _forward_from_embeddings(dec_c, frozen_c, cfg, embeddings,
                                             batch, orig_hw,
                                             config.prompt_type)
            return _loss_from_masks(masks, batch, config)

    return step


def precompute_embeddings(sd: dict, cfg: SamConfig,
                          dataset: PromptedDataset, *, batch_size: int = 8,
                          microbatch: int = 1, dtype=torch.bfloat16,
                          verbose: bool = True) -> torch.Tensor:
    """Encode every image once (the encoder is frozen, so its output is
    constant across epochs). ``sd`` is the f32 state_dict on the device to
    run on; the activations run in ``dtype`` (with f32 weights, as the JAX
    package's precompute). Returns (N, G, G, C) in ``dtype`` on that
    device; the host decodes the next chunk of images in a thread while the
    card encodes."""
    dev = sd["vision_encoder.pos_embed"].device
    n = len(dataset)
    chunks = [range(i0, min(i0 + batch_size, n))
              for i0 in range(0, n, batch_size)]
    t0 = time.perf_counter()
    outs = []
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(lambda c: np.stack([dataset.image(i) for i in c]),
                            c) for c in chunks]
        with full_fp32():
            for fut in futs:
                imgs = torch.as_tensor(fut.result()).to(dev)
                outs.append(_encode(sd, cfg, imgs, dtype, microbatch))
    emb = torch.cat(outs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if verbose:
        print(f"[cache] encoded {n} images in {time.perf_counter() - t0:.1f}s "
              f"({emb.numel() * emb.element_size() / 2**20:.0f} MiB on "
              f"{dev.type})")
    return emb


def training(config: TrainConfig, logger: MultiLogger | None = None, *,
             splits=None, device=None) -> dict:
    """Full training entry (the JAX package's ``training``).

    ``splits``: optional (train_items, valid_items), indexable sequences of
    {'image', 'label'} — what ``load_split`` returns; without it the splits
    are read from ``config.dataset`` (needs ``datasets``). ``device``: the
    card unless the caller passes another (``"cpu"``).

    Returns {'params', 'cfg', 'history', 'checkpoint_dir'}, and 'metrics'
    (the evaluation report on the validation set, run on ``device`` or,
    with ``config.eval_device == "cpu"``, on the host) when
    ``config.evaluate``."""
    _check_supported(config)
    dev = resolve_device(device)
    if logger is None:
        logger = make_logger(
            jsonl_path=config.log_jsonl or os.path.join(
                config.checkpoint, config.display_name, "metrics.jsonl"),
            use_wandb=config.use_wandb,
            wandb_kwargs={"project": config.project_name,
                          "entity": config.entity,
                          "name": config.display_name,
                          "config": dataclasses.asdict(config),
                          "dir": config.wandb_dir})
    try:
        return _training_impl(config, logger, splits, dev)
    finally:
        logger.finish()


def _training_impl(config: TrainConfig, logger: MultiLogger, splits,
                   dev: torch.device) -> dict:
    cfg, sd = prepare_model(config)
    sd = {k: v.to(dev) for k, v in sd.items()}
    if splits is None:
        splits = (load_split(config.dataset, "train"),
                  load_split(config.dataset, "test"))
    train_ds = PromptedDataset(splits[0], prompt_type=config.prompt_type,
                               pseudocolor=config.pseudocolor,
                               seed=config.seed)
    valid_ds = PromptedDataset(splits[1], prompt_type=config.prompt_type,
                               pseudocolor=config.pseudocolor,
                               seed=config.seed + 1)
    orig_hw = train_ds.image(0).shape[:2]

    params, frozen = _split_params(sd, config.trainable)
    for v in params.values():
        v.requires_grad_(True)
    optimizer = make_optimizer(config, params.values())

    run_dir = os.path.join(config.checkpoint, config.display_name)
    os.makedirs(run_dir, exist_ok=True)
    start_epoch = 0
    if config.resume:
        state, _ = ckpt_utils.restore_checkpoint(run_dir)
        if state is not None:
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(state["params"][k])
            optimizer.load_state_dict(state["opt_state"])
            start_epoch = int(state["epoch"]) + 1
            print(f"[resume] from epoch {start_epoch}")

    dtype = _dtype(config)
    use_cache = config.cache_embeddings
    train_emb = valid_emb = train_cm = valid_cm = None
    if use_cache:
        train_emb = precompute_embeddings(sd, cfg, train_ds, dtype=dtype,
                                          microbatch=config.encoder_microbatch)
        valid_emb = precompute_embeddings(sd, cfg, valid_ds, dtype=dtype,
                                          microbatch=config.encoder_microbatch)

        # the component maps are constant too: staged on the card once as
        # uint8 (slots above any bucket never become a loss channel, so the
        # clip to 255 is inert)
        def stage_comp_maps(ds):
            cm = np.stack([np.minimum(ds.comp_map(i), 255)
                           for i in range(len(ds))]).astype(np.uint8)
            return torch.as_tensor(cm).to(dev)

        train_cm, valid_cm = stage_comp_maps(train_ds), stage_comp_maps(valid_ds)

    train_step = make_train_step(cfg, config, optimizer, orig_hw, use_cache)
    eval_step = make_eval_step(cfg, config, orig_hw, use_cache)

    def device_batch(batch, emb, cm):
        keys = ["prompts", "channel_mask", "point_labels"]
        if cm is None:
            keys.append("comp_map")
        out = {k: torch.as_tensor(batch[k]).to(dev) for k in keys
               if k in batch}
        # pad rows carry the -1 sentinel; whatever row they gather is
        # loss-inert through their all-zero channel_mask
        idx = torch.as_tensor(np.maximum(batch["indices"], 0),
                              dtype=torch.long).to(dev)
        if cm is not None:
            out["comp_map"] = cm.index_select(0, idx).to(torch.int32)
        if use_cache:
            out["embeddings"] = emb.index_select(0, idx)
        else:
            out["image"] = torch.as_tensor(batch["image"]).to(dev)
        return out

    history = []
    timer = StepTimer(logger, prefix="perf/train", device=dev)
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        losses = []
        for batch in batches(train_ds, config.batch_size,
                             shuffle=config.shuffle, seed=config.seed,
                             epoch=epoch, buckets=config.buckets,
                             with_images=not use_cache):
            db = device_batch(batch, train_emb, train_cm)
            with timer:
                params, optimizer, loss = train_step(params, optimizer,
                                                     frozen, db)
            losses.append(loss)
        t_train = time.time() - t0
        # one device fetch for the epoch, not one sync per step
        total = float(torch.stack(losses).sum()) if losses else 0.0
        count = len(losses)
        t_sync = time.time() - t0 - t_train
        train_loss = total / max(count, 1)
        logger.log({"train/train_loss": train_loss, "train/epoch": epoch})
        timer.log_summary()

        vlosses = [eval_step(params, frozen, device_batch(b, valid_emb,
                                                          valid_cm))
                   for b in batches(valid_ds, config.batch_size, epoch=epoch,
                                    buckets=config.buckets,
                                    with_images=not use_cache)]
        vtotal = float(torch.stack(vlosses).sum()) if vlosses else 0.0
        t_val = time.time() - t0 - t_train - t_sync
        valid_loss = vtotal / max(len(vlosses), 1)
        logger.log({"val/valid_loss": valid_loss, "val/epoch": epoch})
        dt = time.time() - t0
        n_img = count * config.batch_size
        print(f"EPOCH: {epoch}, Train Loss: {train_loss:.4f}, "
              f"Valid Loss: {valid_loss:.4f} ({dt:.1f}s, {n_img / dt:.1f} "
              f"img/s; train {t_train:.1f}s sync {t_sync:.1f}s val "
              f"{t_val:.1f}s)")
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "valid_loss": valid_loss, "seconds": dt})
        t_ck = time.time()
        ckpt_utils.save_checkpoint(
            run_dir, epoch, {"params": params,
                             "opt_state": optimizer.state_dict(),
                             "epoch": epoch},
            keep=config.ckpt_keep)
        print(f"[epoch {epoch}] ckpt {time.time() - t_ck:.1f}s")

    params_final = _merge_params({k: v.detach() for k, v in params.items()},
                                 frozen)
    if config.export_pt:
        name = f"{config.display_name}_{config.time or 'final'}.pt"
        ckpt_utils.export_reference_pt(
            params_final, os.path.join(config.checkpoint, name))
    result = {"params": params_final, "cfg": cfg, "history": history,
              "checkpoint_dir": run_dir}
    if config.evaluate:
        from ..eval.harness import evaluate_metrics

        result["metrics"] = evaluate_metrics(
            params_final, cfg, config, valid_ds, orig_hw=orig_hw, device=dev)
    return result
