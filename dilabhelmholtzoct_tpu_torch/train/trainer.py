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

With ``topological`` the loss gains the topological term
(``ops/topology.py``), in the JAX package's three modes: ``topo_device``
(the default) pairs and matches on the card inside the step
(``ops/topology_device.py``, kernels T1 / T2); otherwise the host pairs
(``ops/native.py``), synchronously (``topo_pipeline=False``: one forward,
its detached grids to the host, the pairing, the loss and the backward) or
pipelined with a one-batch delay (the default host mode: each call pairs the
previous batch while this one's grids copy to the host; the first call
returns ``loss=None`` and ``step.flush`` runs the last batch). Both host
modes cache the ground-truth diagrams across epochs and skip bucket-padding
rows; the epoch loop feeds each host batch through ``set_host_batch``.

With ``data_transforms`` the train split is augmented on the host
(``data/augment.py``; it needs ``cache_embeddings=False``, as in JAX), and
``pseudocolor`` maps both splits through a colormap LUT. With
``display_mode`` other than 'none' the sample overlays of
``train/display.py`` are made before the first epoch and after each
epoch's checkpoint; with ``profile_dir`` the first epoch run is traced
(``utils/profiling.profile_trace``).

Data parallelism (``parallel/``) runs one process per card over
``torch.distributed``: ``training`` joins the group with ``multihost`` (the
explicit path, from the env ``torchrun`` sets), or with ``data_parallel`` in
a process that ``torchrun`` started as one of a group (``WORLD_SIZE`` > 1),
and runs on ``cuda:LOCAL_RANK`` (NCCL; gloo for ``device="cpu"``). Every
rank iterates the same seeded batches, pads each to a multiple of the rank
count and takes its own rows; the loss is each rank's numerator over the
global batch's denominator, and the step sums the gradients and the loss
over the ranks in one all-reduce before the optimizer, so every rank holds
the JAX package's sharded step: the single-device step on the padded
global batch. Rank 0 alone logs, writes checkpoints, exports and evaluates.
In a single process without ``torchrun`` ``data_parallel`` is a no-op.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.augment import make_augmenter
from ..data.pipeline import PromptedDataset, batches
from ..data.sampling import DEFAULT_BUCKETS, gt_masks_from_comp_map
from ..data.store import load_split
from ..device import full_fp32, resolve_device
from ..models.configs import SamConfig, config_for
from ..models.sam import (
    PROMPT_PE,
    SHARED_PE,
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
from ..ops.topology import (
    downsample_grid,
    host_pairing,
    pairing_to,
    topo_loss_from_pairing,
    true_diagrams_from_grids,
)
from ..ops.topology_device import topo_loss_device
from ..parallel import distributed as dist
from ..parallel.mesh import pad_to_multiple, replicate, shard_batch
from ..utils import checkpoint as ckpt_utils
from ..utils.logging import MultiLogger, make_logger
from ..utils.profiling import StepTimer, profile_trace
from .display import display_samples

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
    """Raise for configurations the run cannot take; ``loop=False`` checks
    only what a train step itself runs."""
    if config.trainable not in ("decoder", "all"):
        raise ValueError(f"unknown trainable {config.trainable!r}")
    if not loop:
        return
    if config.topological and config.multihost and not config.topo_device:
        # the JAX package's rule (its host pairing needs fully-addressable
        # grids there); topo_device composes with multihost
        raise ValueError(
            "topological=True with the host pairing protocol is "
            "incompatible with multihost=True (the pairing needs fully-"
            "addressable grids); use topo_device=True (on-device "
            "persistence) or run topo training single-host")
    if config.data_transforms and config.cache_embeddings:
        raise ValueError(
            "data_transforms requires cache_embeddings=False (augmented "
            "images invalidate cached encoder outputs)")
    if config.trainable == "all" and config.cache_embeddings:
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
    ``model.mask_decoder.parameters()``; "all" trains every entry but
    ``PROMPT_PE``, the second name of the one shared positional embedding
    (JAX's one ``shared_pe`` leaf): writers derive it with
    ``tie_shared_pe``."""
    if trainable == "all":
        return {k: v for k, v in sd.items() if k != PROMPT_PE}, {}
    decoder = {k: v for k, v in sd.items() if k.startswith(DECODER_PREFIX)}
    frozen = {k: v for k, v in sd.items() if not k.startswith(DECODER_PREFIX)}
    return decoder, frozen


def _merge_params(decoder: dict, frozen: dict) -> dict:
    return {**frozen, **decoder}


def tie_shared_pe(sd: dict) -> dict:
    """``sd`` with ``PROMPT_PE`` set to the ``SHARED_PE`` tensor, as JAX
    writes its one ``shared_pe`` leaf under both HF names; ``sd`` as it is
    when it holds no ``SHARED_PE`` (the decoder's entries)."""
    if SHARED_PE not in sd:
        return sd
    return {**sd, PROMPT_PE: sd[SHARED_PE]}


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


def _loss_from_masks(masks, batch, config: TrainConfig, pairing=None):
    """DiceCE (or one of its parts) against the component masks, plus the
    topological term of the sigmoid of the f32 masks: paired on the device
    with ``topo_device``, else from the host's ``pairing`` when one is
    given."""
    gt = gt_masks_from_comp_map(batch["comp_map"], masks.shape[1])
    loss = segmentation_loss(config.loss)(masks, gt, batch["channel_mask"])
    if config.topological and config.topo_device:
        loss = loss + topo_loss_device(
            torch.sigmoid(masks.float()), gt, config.topo_lamda,
            interp=config.topo_interp, feat_d=config.topo_feat_d,
            channel_mask=batch["channel_mask"])
    elif config.topological and pairing is not None:
        loss = loss + topo_loss_from_pairing(
            torch.sigmoid(masks.float()), pairing, config.topo_lamda,
            interp=config.topo_interp, channel_mask=batch["channel_mask"])
    return loss


_EMPTY_DIAG = np.zeros((0, 2), np.float32)


class _TopoHostPairer:
    """The host half of the topological loss, one per step function (train
    and eval): the cross-epoch cache of ground-truth diagrams (exact: the
    targets are the component masks, constant across epochs; off under
    augmentation), the skip of bucket-padding rows, and on a cache hit the
    copy of the active rows' pred grids only. Callers feed the host batch
    (sample indices and channel mask) through ``set_host_batch`` before each
    step; without it every step pairs both grids, uncached."""

    def __init__(self, config: TrainConfig):
        self.config = config
        self.use_cache = config.topo_true_cache and not config.data_transforms
        self.cache: dict[int, list] = {}
        self.meta = None

    def set_host_batch(self, batch) -> None:
        idxs = batch.get("indices")
        self.meta = (None if idxs is None else [int(i) for i in
                                                np.asarray(idxs)],
                     np.asarray(batch["channel_mask"]))

    def cache_hit(self, meta) -> bool:
        if not (self.use_cache and meta is not None and meta[0] is not None):
            return False
        # padding rows (all-zero channel_mask) need no cached diagrams
        counts = np.asarray(meta[1]).sum(axis=1)
        return all(ix in self.cache
                   for ix, cnt in zip(meta[0], counts) if cnt > 0)

    def grids(self, masks, batch, meta):
        """The detached downsampled grids to pair: (pred (R, i, i), true
        (N, i, i) or None on a cache hit, rows): on a cache hit with padding
        rows, ``rows`` lists the active rows and pred holds only those."""
        interp = self.config.topo_interp
        with torch.no_grad():
            pred = downsample_grid(torch.sigmoid(masks.detach().float()),
                                   interp)
            n = pred.shape[0] * pred.shape[1]
            pred = pred.reshape(n, *pred.shape[2:])
            if self.cache_hit(meta):
                rows = np.flatnonzero(np.asarray(meta[1]).reshape(-1) > 0)
                if len(rows) == n:
                    return pred, None, None
                return pred.index_select(0, torch.as_tensor(
                    rows, device=pred.device)), None, rows
            gt = gt_masks_from_comp_map(batch["comp_map"], masks.shape[1])
            true = downsample_grid(gt, interp)
            return pred, true.reshape(n, *true.shape[2:]), None

    @staticmethod
    def to_host(grids, non_blocking: bool = False):
        """The grids on the host, with the device the pairing goes back to:
        (pred, true, rows, device, event). With ``non_blocking`` a card's
        grids copy into pinned memory behind an event, which ``pair``
        waits on."""
        pred, true, rows = grids
        dev = pred.device
        if dev.type != "cuda":
            return pred, true, rows, dev, None
        if not non_blocking:
            return (pred.cpu(), None if true is None else true.cpu(), rows,
                    dev, None)

        def copy(x):
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x, non_blocking=True)

        pred_h = copy(pred)
        true_h = None if true is None else copy(true)
        event = torch.cuda.Event()
        event.record()
        return pred_h, true_h, rows, dev, event

    def _cached(self, ix: int, slot: int):
        slots = self.cache.get(ix, [])
        return slots[slot] if slot < len(slots) else _EMPTY_DIAG

    def pair(self, host, meta) -> dict:
        """The pairing of grids on the host (``to_host``), as tensors on
        their device."""
        pred, true, rows, dev, event = host
        if event is not None:
            event.synchronize()
        pred = pred.numpy()
        true = None if true is None else true.numpy()
        feat_d = self.config.topo_feat_d
        if meta is None or meta[0] is None or not self.use_cache:
            return pairing_to(host_pairing(
                pred, true, feat_d=feat_d,
                row_mask=None if meta is None else meta[1].reshape(-1)), dev)
        idxs, cmask = meta
        bucket = cmask.shape[1]
        if true is None:  # cache hit
            if rows is not None:  # only the active rows were copied
                full = np.zeros((cmask.size, *pred.shape[1:]), np.float32)
                full[rows] = pred
                pred = full
            diagrams = [self._cached(ix, s) for ix in idxs
                        for s in range(bucket)]
        else:  # miss: the true diagrams once, into the cache
            diagrams = true_diagrams_from_grids(true, feat_d)
            for bi, ix in enumerate(idxs):
                cnt = int(cmask[bi].sum())
                if cnt:  # never padding rows: their index names no sample
                    self.cache[ix] = [diagrams[bi * bucket + s]
                                      for s in range(cnt)]
        return pairing_to(host_pairing(
            pred, None, feat_d=feat_d, true_diagrams=diagrams,
            row_mask=cmask.reshape(-1)), dev)


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
    microbatching, for ``trainable='all'`` (the JAX step).

    With ``topological`` and not ``topo_device`` the step pairs on the host
    and has ``set_host_batch`` (the host batch before each call); pipelined
    (``topo_pipeline``) it returns ``loss=None`` for the batch it defers and
    has ``flush(params, optimizer, frozen)``, which runs the last one.

    In a process group (data parallelism) ``batch`` holds this rank's rows:
    the gradients and the returned loss are summed over the ranks before
    the update, so each is the whole padded batch's."""
    _check_supported(config, loop=False)
    dtype = _dtype(config)
    train_encoder = config.trainable == "all"

    def masks_of(params, frozen, batch, remat=True):
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
                    _merge_params(params_c, frozen_c), pix, cfg, remat=remat)
            else:
                embeddings = _encode(frozen_c, cfg, batch["image"], dtype,
                                     config.encoder_microbatch)
        return _forward_from_embeddings(params_c, frozen_c, cfg, embeddings,
                                        batch, orig_hw, config.prompt_type)

    def update(params, optimizer, frozen, batch, pairing=None):
        with full_fp32():
            masks = masks_of(params, frozen, batch)
            return _apply(params, optimizer, _loss_from_masks(
                masks, batch, config, pairing))

    def _apply(params, optimizer, loss):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _zero_missing_grads(optimizer)
        loss = loss.detach()
        # data parallelism: the global gradients and loss (identity alone)
        dist.all_reduce_sum_([loss] + [p.grad for g in optimizer.param_groups
                                       for p in g["params"]])
        optimizer.step()
        return params, optimizer, loss

    if not config.topological or config.topo_device:
        return update

    pairer = _TopoHostPairer(config)
    if not config.topo_pipeline:
        # one forward: its detached grids go to the host for the pairing,
        # and the loss and backward use the same masks (JAX runs the
        # forward twice at the same parameters, to the same numbers)
        def topo_step(params, optimizer, frozen, batch):
            meta = pairer.meta
            with full_fp32():
                masks = masks_of(params, frozen, batch)
                pairing = pairer.pair(pairer.to_host(
                    pairer.grids(masks, batch, meta)), meta)
                return _apply(params, optimizer, _loss_from_masks(
                    masks, batch, config, pairing))

        topo_step.set_host_batch = pairer.set_host_batch
        return topo_step

    # Pipelined: batch k's grids come from a no-grad forward at the current
    # parameters and copy to the host while the host pairs batch k-1, whose
    # full step then runs with that pairing (one update stale; the loss and
    # gradient values use the current parameters).
    state = {"pending": None}

    def run_pending(params, optimizer, frozen):
        prev, state["pending"] = state["pending"], None
        if prev is None:
            return params, optimizer, None
        batch, host, meta = prev
        return update(params, optimizer, frozen, batch,
                      pairer.pair(host, meta))

    def topo_step_pipelined(params, optimizer, frozen, batch):
        meta = pairer.meta
        with torch.no_grad(), full_fp32():
            grids = pairer.grids(masks_of(params, frozen, batch, remat=False),
                                 batch, meta)
        host = pairer.to_host(grids, non_blocking=True)
        out = run_pending(params, optimizer, frozen)
        state["pending"] = (batch, host, meta)
        return out

    topo_step_pipelined.flush = run_pending
    topo_step_pipelined.set_host_batch = pairer.set_host_batch
    return topo_step_pipelined


def make_eval_step(cfg: SamConfig, config: TrainConfig, orig_hw,
                   from_embeddings: bool):
    """``step(decoder, frozen, batch) -> loss``: the train step's forward and
    loss, in the same compute dtype, without gradients. With
    ``topological`` on the host it pairs synchronously through a pairer of
    its own (``set_host_batch``). In a process group the loss is summed over
    the ranks: the whole padded batch's."""
    dtype = _dtype(config)

    def masks_of(decoder, frozen, batch):
        dec_c = _cast_floats(decoder, dtype)
        if from_embeddings:
            embeddings = batch["embeddings"].to(dtype)
            frozen_c = _cast_floats(_prompt_entries(frozen), dtype)
        else:
            frozen_c = _cast_floats(frozen, dtype)
            embeddings = _encode(_merge_params(dec_c, frozen_c), cfg,
                                 batch["image"], dtype,
                                 config.encoder_microbatch)
        return _forward_from_embeddings(dec_c, frozen_c, cfg, embeddings,
                                        batch, orig_hw, config.prompt_type)

    def global_loss(loss):
        dist.all_reduce_sum_([loss])  # data parallelism (identity alone)
        return loss

    if not config.topological or config.topo_device:
        @torch.no_grad()
        def step(decoder, frozen, batch):
            with full_fp32():
                return global_loss(_loss_from_masks(
                    masks_of(decoder, frozen, batch), batch, config))

        return step

    pairer = _TopoHostPairer(config)

    @torch.no_grad()
    def topo_step(decoder, frozen, batch):
        meta = pairer.meta
        with full_fp32():
            masks = masks_of(decoder, frozen, batch)
            pairing = pairer.pair(pairer.to_host(
                pairer.grids(masks, batch, meta)), meta)
            return global_loss(_loss_from_masks(masks, batch, config,
                                                pairing))

    topo_step.set_host_batch = pairer.set_host_batch
    return topo_step


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
    ``config.evaluate`` (on rank 0 alone under data parallelism)."""
    _check_supported(config)
    dev = _join_group(config, device)
    if logger is None and dist.process_index() != 0:
        logger = make_logger(quiet=True)
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


def _join_group(config: TrainConfig, device) -> torch.device:
    """Join the data-parallel group where the run asks for one:
    ``multihost`` (explicit: it warns and goes on alone without the env),
    or ``data_parallel`` in a process that ``torchrun`` started as one of a
    group. Returns the device this rank runs on: ``device``, else
    ``cuda:LOCAL_RANK`` in a group and ``cuda`` alone."""
    join = config.multihost or (
        config.data_parallel and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not join:
        return resolve_device(device)
    dev = resolve_device(f"cuda:{dist.local_rank()}" if device is None
                         else device)
    dist.initialize(explicit=config.multihost,
                    backend="nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        print(f"[dp] data-parallel over {dist.process_count()} ranks")
    return dev


def _training_impl(config: TrainConfig, logger: MultiLogger, splits,
                   dev: torch.device) -> dict:
    primary = dist.process_index() == 0
    cfg, sd = prepare_model(config)
    sd = {k: v.to(dev) for k, v in sd.items()}
    replicate(sd.values())  # rank 0's weights on every rank
    if splits is None:
        splits = (load_split(config.dataset, "train"),
                  load_split(config.dataset, "test"))
    train_ds = PromptedDataset(splits[0], prompt_type=config.prompt_type,
                               pseudocolor=config.pseudocolor,
                               seed=config.seed,
                               augment=make_augmenter(config.data_transforms))
    valid_ds = PromptedDataset(splits[1], prompt_type=config.prompt_type,
                               pseudocolor=config.pseudocolor,
                               seed=config.seed + 1)
    orig_hw = train_ds.image(0).shape[:2]

    params, frozen = _split_params(sd, config.trainable)
    for v in params.values():
        v.requires_grad_(True)
    optimizer = make_optimizer(config, params.values())

    run_dir = os.path.join(config.checkpoint, config.display_name)
    if primary:
        os.makedirs(run_dir, exist_ok=True)
    start_epoch = 0
    if config.resume:  # every rank restores the same checkpoint
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

    def local_batch(batch):
        """Under data parallelism, the host batch padded to the rank count
        (before the topological pairer sees it, so its rows are the
        step's), then this rank's rows; the batch as it is alone."""
        if not dist.is_initialized():
            return batch
        padded, _ = pad_to_multiple(
            {k: v for k, v in batch.items()
             if k in ("prompts", "comp_map", "channel_mask", "point_labels",
                      "indices", "image")},
            dist.process_count())
        return shard_batch(padded)

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

    def run_display(epoch):
        if config.display_mode == "none" or not primary:
            return
        full = _merge_params({k: v.detach() for k, v in params.items()},
                             frozen)
        for split, ds in (("train", train_ds), ("test", valid_ds)):
            display_samples(full, cfg, config, ds, split, logger, run_dir,
                            epoch=epoch, orig_hw=orig_hw, device=dev)

    history = []
    timer = StepTimer(logger, prefix="perf/train", device=dev)
    run_display(start_epoch - 1)
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        losses = []
        trace = (profile_trace(config.profile_dir, dev)
                 if epoch == start_epoch else contextlib.nullcontext())
        with trace:
            for batch in batches(train_ds, config.batch_size,
                                 shuffle=config.shuffle, seed=config.seed,
                                 epoch=epoch, buckets=config.buckets,
                                 with_images=not use_cache):
                batch = local_batch(batch)
                if hasattr(train_step, "set_host_batch"):
                    train_step.set_host_batch(batch)  # the GT-diagram cache
                db = device_batch(batch, train_emb, train_cm)
                with timer:
                    params, optimizer, loss = train_step(params, optimizer,
                                                         frozen, db)
                if loss is not None:  # the pipelined host mode defers one
                    losses.append(loss)
            if hasattr(train_step, "flush"):
                params, optimizer, loss = train_step.flush(params, optimizer,
                                                           frozen)
                if loss is not None:
                    losses.append(loss)
        t_train = time.time() - t0
        # one device fetch for the epoch, not one sync per step
        total = float(torch.stack(losses).sum()) if losses else 0.0
        count = len(losses)
        t_sync = time.time() - t0 - t_train
        train_loss = total / max(count, 1)
        logger.log({"train/train_loss": train_loss, "train/epoch": epoch})
        timer.log_summary()

        vlosses = []
        for b in batches(valid_ds, config.batch_size, epoch=epoch,
                         buckets=config.buckets, with_images=not use_cache):
            b = local_batch(b)
            if hasattr(eval_step, "set_host_batch"):
                eval_step.set_host_batch(b)
            vlosses.append(eval_step(params, frozen,
                                     device_batch(b, valid_emb, valid_cm)))
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
        if primary:  # the parameters are the same on every rank
            ckpt_utils.save_checkpoint(
                run_dir, epoch, {"params": tie_shared_pe(params),
                                 "opt_state": optimizer.state_dict(),
                                 "epoch": epoch},
                keep=config.ckpt_keep)
        run_display(epoch)
        dist.barrier()
        print(f"[epoch {epoch}] ckpt+display {time.time() - t_ck:.1f}s")

    params_final = tie_shared_pe(_merge_params(
        {k: v.detach() for k, v in params.items()}, frozen))
    if config.export_pt and primary:
        name = f"{config.display_name}_{config.time or 'final'}.pt"
        ckpt_utils.export_reference_pt(
            params_final, os.path.join(config.checkpoint, name))
    result = {"params": params_final, "cfg": cfg, "history": history,
              "checkpoint_dir": run_dir}
    if config.evaluate and primary:
        from ..eval.harness import evaluate_metrics

        result["metrics"] = evaluate_metrics(
            params_final, cfg, config, valid_ds, orig_hw=orig_hw, device=dev)
    dist.barrier()
    return result
