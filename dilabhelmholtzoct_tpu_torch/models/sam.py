"""SAM (Segment Anything) forward in PyTorch, on an HF-named state_dict.

Port of ``dilabhelmholtzoct_tpu/models/sam.py`` for the serving and the
fine-tuning paths:

  * ViTDet image encoder (windowed + global attention with decomposed
    relative-position bias, convolutional neck);
  * prompt encoder (random-Fourier positional encoding, point and box
    embeddings, the dense embedding of a mask input or the broadcast
    no-mask one);
  * two-way-transformer mask decoder (iou head, hypernetwork MLPs, the
    transposed-conv upscaler in the natural or the blocked layout).

Activations are NHWC and the fused qkv stays (B, N, 3C), as in the JAX
package, so each function here is compared with its JAX counterpart on the
same inputs. Parameters are the HF ``SamModel`` state_dict (see
``models/convert.py``); every function takes it as ``sd``. The encoder's
attention goes through ``ops/attention.py::flash_attention_packed`` — the
CUDA kernels on the card (K1 / K2 forward and K5 backward at head dim 64, K6
at any other, as ViT-H's 80), the plain versions on the host — at >= 196
tokens (``set_flash_attention``; below, and under 'off', the materialized
route in plain PyTorch, which also trains ViT-H's encoder) and, under
``set_fused_windowed('on')``, its windowed layers through
``flash_attention_windowed_image`` (K7). In bf16 (the
training compute dtype) the decoder's image->token update goes through
``ops/decoder_attn.py::fused_i2t_ln`` (K4) and the blocked upscaler through
``ops/upscaler.py::upscale_hyper_masks`` (K3), as the JAX package routes its
Pallas kernels; f32 stays on the unfused chain. bf16 products sum in f32 and
round once, where JAX does. The rest is plain PyTorch; on the card run it
under ``device.full_fp32`` (no TF32).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    HEAD_DIM,
    flash_attention_packed,
    flash_attention_windowed_image,
    window_partition,
    window_unpartition,
)
from ..ops.decoder_attn import T_PAD, fused_i2t_ln
from ..ops.upscaler import upscale_hyper_masks
from ..ops.preprocess import resize_matrix
from .configs import DecoderConfig, SamConfig, VisionConfig
from .convert import params_from_jax

SHARED_PE = "shared_image_embedding.positional_embedding"
# HF's second name of the same tensor (SamModel ties the two); the model
# reads only SHARED_PE, and writers derive this one from it
PROMPT_PE = "prompt_encoder.shared_embedding.positional_embedding"

# ---------------------------------------------------------------------------
# Small building blocks
# ---------------------------------------------------------------------------


def layer_norm(x, sd, prefix: str, eps: float):
    """LayerNorm over the trailing axis, computed in f32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), sd[f"{prefix}.weight"].float(),
                     sd[f"{prefix}.bias"].float(), eps)
    return y.to(x.dtype)


def linear(x, sd, prefix: str):
    """``x @ W.T + b`` with an HF (out, in) weight: the product of x's dtype
    operands summed in f32, the f32 bias added to the f32 sum, one rounding
    to x's dtype at the end (the JAX package's ``preferred_element_type=f32``
    dot). bf16 operands widen exactly to f32, so an f32 product of the
    widened copies is that sum; an f32 weight with a bf16 x multiplies in
    f32, as JAX promotes the pair."""
    w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    if x.dtype == torch.float32:
        return F.linear(x, w.float(), b.float())
    return F.linear(x.float(), w.float(), b.float()).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU in f32, the tanh form in bf16 — as the JAX package."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


# ---------------------------------------------------------------------------
# Vision encoder
# ---------------------------------------------------------------------------


def resize_rel_pos(rel_pos, target_len: int):
    """Linearly resample a relative-position table to ``target_len`` rows
    (half-pixel centres, no antialias). Identity at native geometry."""
    if rel_pos.shape[0] == target_len:
        return rel_pos
    op = torch.as_tensor(
        resize_matrix(rel_pos.shape[0], target_len, antialias=False),
        device=rel_pos.device)
    return (op @ rel_pos.float()).to(rel_pos.dtype)


def rel_pos_table(rel_pos, q_size: int, k_size: int):
    """Per-(q, k) relative position embeddings → (q_size, k_size, dim)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    rel_pos = resize_rel_pos(rel_pos, max_rel_dist)
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.as_tensor(idx.astype(np.int64), device=rel_pos.device)]


# The JAX package's encoder attention switch (``models/sam.py``
# ``set_flash_attention``), with its four modes and its rule. 'interpret'
# names the Pallas interpreter there; here it is the flash route, as 'on':
# the kernel on a CUDA tensor, its plain version on a CPU tensor.
_FLASH_MODE = "auto"
_FLASH_MIN_TOKENS = 196  # SAM's 14 x 14 windows take the flash route too


def set_flash_attention(mode: str):
    """mode in {'auto', 'on', 'off', 'interpret'} — the encoder attention's
    route: the flash route (``ops/attention.py::flash_attention_packed``:
    K1 / K2 and K5 at head dim 64 with an even head count, K6 at any other)
    or the materialized route (``_materialized_attention``: f32 logits with
    the full (B, heads, N, N) rel-pos bias, plain PyTorch under autograd,
    the JAX package's XLA path). 'auto' takes the flash route at >= 196
    tokens, as the JAX package does on an accelerator; 'on' and 'interpret'
    always; 'off' never. Training the encoder at a head dim other than 64
    (ViT-H, ``trainable='all'``) needs 'off': K6 has no backward, as the
    JAX package's has none."""
    global _FLASH_MODE
    if mode not in ("auto", "on", "off", "interpret"):
        raise ValueError(f"unknown flash-attention mode {mode!r}")
    _FLASH_MODE = mode


def _use_flash(n_tokens: int) -> bool:
    """The JAX package's ``_use_flash``; its 'auto' as on an accelerator."""
    if _FLASH_MODE == "off":
        return False
    if _FLASH_MODE in ("on", "interpret"):
        return True
    return n_tokens >= _FLASH_MIN_TOKENS


def _materialized_attention(qkv, rel_h, rel_w, hw, n_heads: int):
    """The JAX package's attention off the flash route (``vision_attention``
    under ``set_flash_attention('off')``): q scaled in its dtype, the logits
    of the products summed in f32, plus the decomposed rel-pos bias (built
    in q's dtype from rel_h / rel_w, or none when they are None), an f32
    softmax rounded to v's dtype, and the product with v summed in f32 and
    rounded once. qkv (B, N, 3C) -> (B, N, C)."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // n_heads
    q, k, v = qkv.reshape(b, n, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    scale = torch.tensor(d ** -0.5, dtype=qkv.dtype, device=qkv.device)
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if rel_h is not None:
        h, w = hw
        bias = (rel_h.reshape(b, n_heads, n, h, 1)
                + rel_w.reshape(b, n_heads, n, 1, w))
        logits = logits + bias.reshape(b, n_heads, n, n).float()
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(attn.float(), v.float()).to(v.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, c3 // 3)


def vision_attention(x, sd, prefix: str, cfg: VisionConfig):
    """Multi-head self-attention with decomposed rel-pos bias on
    x (B, H, W, C); B is batch x windows for windowed layers. The route is
    ``set_flash_attention``'s."""
    b, h, w, c = x.shape
    n_heads = cfg.num_heads
    qkv = linear(x.reshape(b, h * w, c), sd, f"{prefix}.qkv")  # (B, HW, 3C)
    rel_h = rel_w = None
    if cfg.use_rel_pos:
        rh = rel_pos_table(sd[f"{prefix}.rel_pos_h"], h, h).to(x.dtype)
        rw = rel_pos_table(sd[f"{prefix}.rel_pos_w"], w, w).to(x.dtype)
        q_nat = qkv[:, :, :c].reshape(b, h, w, n_heads, c // n_heads)
        rel_h = torch.einsum("bxyhc,xkc->bhxyk", q_nat, rh).reshape(
            b, n_heads, h * w, h).contiguous()
        rel_w = torch.einsum("bxyhc,ykc->bhxyk", q_nat, rw).reshape(
            b, n_heads, h * w, w).contiguous()
    if cfg.use_rel_pos and _use_flash(h * w):
        out = flash_attention_packed(qkv, rel_h, rel_w, hw=(h, w),
                                     num_heads=n_heads)
    else:
        out = _materialized_attention(qkv, rel_h, rel_w, (h, w), n_heads)
    return linear(out.reshape(b, h, w, c), sd, f"{prefix}.proj")


_FUSED_WINDOWED = "auto"


def set_fused_windowed(mode: str):
    """mode in {'auto', 'on', 'off', 'interpret'} — the JAX package's switch
    of the same name: with 'on' the windowed layers of a non-checkpointed
    encode read the image-layout qkv through
    ``ops/attention.py::flash_attention_windowed_image`` (K7), and the pad,
    the two window transposes and the crop of the partitioned route never
    run. 'auto' resolves to off, the JAX package's default (set there after a
    TPU measurement; which route wins on a given card is for
    ``chip_smoke.py`` to time, both are kept). 'interpret' names the Pallas
    interpreter there and means nothing here: it is taken as 'on'.
    Forward-only; a checkpointed encode (encoder training) keeps the
    partitioned route, which has the backward."""
    global _FUSED_WINDOWED
    if mode not in ("auto", "on", "off", "interpret"):
        raise ValueError(f"unknown fused-windowed mode {mode!r}")
    _FUSED_WINDOWED = mode


def _use_fused_windowed(cfg: VisionConfig) -> bool:
    # K7 itself takes any head count; the even-heads test mirrors the JAX
    # package's routing, so that one switch picks the same route in both
    if not (cfg.use_rel_pos and cfg.head_dim == HEAD_DIM
            and cfg.num_heads % 2 == 0):
        return False
    return _FUSED_WINDOWED in ("on", "interpret")


def _windowed_attention_image(x, sd, prefix: str, cfg: VisionConfig, ws: int):
    """Windowed self-attention on the LayerNorm output x (B, H, W, C) with no
    window partition: one qkv projection over the H * W real tokens, the bias
    factors built in image space from row- and column-tiled tables (the
    window row of image row r is r % ws, since windows tile at ws strides),
    K7 on the image layout, then the output projection."""
    b, h, w, c = x.shape
    n_heads = cfg.num_heads
    qkv = linear(x.reshape(b, h * w, c), sd, f"{prefix}.qkv").reshape(
        b, h, w, 3 * c)
    rh = rel_pos_table(sd[f"{prefix}.rel_pos_h"], ws, ws).to(x.dtype)
    rw = rel_pos_table(sd[f"{prefix}.rel_pos_w"], ws, ws).to(x.dtype)
    rh_t = rh.repeat(-(-h // ws), 1, 1)[:h]  # (H, ws, d)
    rw_t = rw.repeat(-(-w // ws), 1, 1)[:w]
    q_img = qkv[..., :c].reshape(b, h, w, n_heads, c // n_heads)
    rel = torch.cat([torch.einsum("bxyhc,xkc->bhxyk", q_img, rh_t),
                     torch.einsum("bxyhc,ykc->bhxyk", q_img, rw_t)], dim=-1)
    out = flash_attention_windowed_image(
        qkv, rel.contiguous(), sd[f"{prefix}.qkv.bias"], ws=ws,
        num_heads=n_heads)
    return linear(out, sd, f"{prefix}.proj")


def vision_layer(x, sd, prefix: str, cfg: VisionConfig, window_size: int,
                 fused_win: bool = False):
    shortcut = x
    x = layer_norm(x, sd, f"{prefix}.layer_norm1", cfg.layer_norm_eps)
    if window_size > 0 and fused_win and _use_fused_windowed(cfg):
        x = _windowed_attention_image(x, sd, f"{prefix}.attn", cfg,
                                      window_size)
    else:
        if window_size > 0:
            # the pad comes AFTER the LN: pad tokens are zeros that the qkv
            # projection turns into its bias, and they take part in
            # attention as unmasked keys (64 → 70 → 25 windows of 196 at
            # ViT-B)
            hw = (x.shape[1], x.shape[2])
            x, padded_hw = window_partition(x, window_size)
        x = vision_attention(x, sd, f"{prefix}.attn", cfg)
        if window_size > 0:
            x = window_unpartition(x, window_size, padded_hw, hw)
    x = shortcut + x
    y = layer_norm(x, sd, f"{prefix}.layer_norm2", cfg.layer_norm_eps)
    y = linear(gelu(linear(y, sd, f"{prefix}.mlp.lin1")), sd,
               f"{prefix}.mlp.lin2")
    return x + y


def encode_image(sd, pixel_values, cfg: SamConfig, *, remat: bool = False):
    """ViTDet encoder: pixel_values (B, H, W, 3) NHWC, preprocessed →
    image embeddings (B, G, G, output_channels) NHWC.

    remat=True checkpoints each transformer layer (the JAX package's
    ``jax.checkpoint`` per layer, the encoder fine-tuning path): the
    backward recomputes the layer, so only its input is kept, and its
    attention runs K1 / K2 once more. Without it the windowed layers may
    take the image-layout route (``set_fused_windowed``), which is
    forward-only."""
    v = cfg.vision
    ps = v.patch_size
    bsz, ih, iw, ic = pixel_values.shape
    gh, gw = ih // ps, iw // ps
    # a non-overlapping patch conv is a space-to-depth reshape + one product
    xp = pixel_values.reshape(bsz, gh, ps, gw, ps, ic)
    xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(bsz, gh, gw, ps * ps * ic)
    w = sd["vision_encoder.patch_embed.projection.weight"]  # (C, 3, ps, ps)
    w_flat = w.permute(2, 3, 1, 0).reshape(ps * ps * ic, -1)
    x = torch.matmul(xp.float(), w_flat.to(xp.dtype).float()).to(xp.dtype)
    x = x + sd["vision_encoder.patch_embed.projection.bias"].to(x.dtype)
    if v.use_abs_pos:
        x = x + sd["vision_encoder.pos_embed"].to(x.dtype)
    for i in range(v.num_layers):
        ws = 0 if i in v.global_attn_indexes else v.window_size
        if remat:
            x = checkpoint(vision_layer, x, sd, f"vision_encoder.layers.{i}",
                           v, ws, use_reentrant=False)
        else:
            x = vision_layer(x, sd, f"vision_encoder.layers.{i}", v, ws,
                             fused_win=True)
    # neck: 1x1 conv → LN(channel) → 3x3 conv → LN(channel), bias-free
    w1 = sd["vision_encoder.neck.conv1.weight"][:, :, 0, 0]
    x = torch.matmul(x.float(), w1.to(x.dtype).float().T).to(x.dtype)
    x = layer_norm(x, sd, "vision_encoder.neck.layer_norm1", 1e-6)
    w2 = sd["vision_encoder.neck.conv2.weight"].to(x.dtype)
    x = F.conv2d(x.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    return layer_norm(x, sd, "vision_encoder.neck.layer_norm2", 1e-6)


def encode_image_microbatched(sd, pixel_values, cfg: SamConfig,
                              microbatch: int = 1):
    """Encode in sequential chunks of ``microbatch`` images, bounding peak
    memory to one chunk's activations; the same result as ``encode_image``
    on the whole batch."""
    b = pixel_values.shape[0]
    if b <= microbatch:
        return encode_image(sd, pixel_values, cfg)
    return torch.cat([encode_image(sd, pixel_values[i:i + microbatch], cfg)
                      for i in range(0, b, microbatch)])


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------


def _fourier_pos_encode(coords01, pe_matrix):
    """Random-Fourier encoding of [0,1] coordinates: (..., 2) →
    (..., 2 * num_pos_feats). The 2*pi factor is taken in the matrix's dtype,
    as JAX takes a Python scalar times a bf16 array."""
    c = 2.0 * coords01 - 1.0
    c = torch.matmul(c.to(pe_matrix.dtype), pe_matrix)
    c = torch.tensor(2.0 * math.pi, dtype=c.dtype, device=c.device) * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def image_wide_pe(sd, cfg: SamConfig):
    """Dense positional encoding over the embedding grid → (G, G, C)."""
    g = cfg.prompt.image_embedding_size
    coords = (np.arange(g, dtype=np.float32) + 0.5) / g
    grid = np.stack(np.meshgrid(coords, coords, indexing="xy"), axis=-1)
    pe = sd[SHARED_PE]
    return _fourier_pos_encode(torch.as_tensor(grid, device=pe.device), pe)


def _embed_row(sd, name):
    return sd[f"prompt_encoder.{name}.weight"][0]


def embed_points(sd, points, labels, cfg: SamConfig, pad: bool):
    """points (B, P, N, 2) xy in input-image space; labels (B, P, N):
    1 foreground, 0 background, -1 'not a point', -10 padding."""
    points = points + 0.5  # pixel-centre shift
    if pad:
        b, pb, _, _ = points.shape
        points = torch.cat([points, points.new_zeros((b, pb, 1, 2))], dim=2)
        labels = torch.cat(
            [labels, -torch.ones((b, pb, 1), dtype=labels.dtype,
                                 device=labels.device)], dim=2)
    size = cfg.prompt.input_image_size
    emb = _fourier_pos_encode(points / size, sd[SHARED_PE])
    lbl = labels[..., None]
    emb = torch.where(lbl == -1, _embed_row(sd, "not_a_point_embed").to(emb.dtype),
                      emb)
    emb = torch.where(lbl == -10, torch.zeros_like(emb), emb)
    emb = torch.where(lbl == 0, emb + _embed_row(sd, "point_embed.0").to(emb.dtype),
                      emb)
    emb = torch.where(lbl == 1, emb + _embed_row(sd, "point_embed.1").to(emb.dtype),
                      emb)
    return emb


def embed_boxes(sd, boxes, cfg: SamConfig):
    """boxes (B, nb, 4) xyxy in input-image space → (B, nb, 2, C)."""
    b, nb, _ = boxes.shape
    corners = (boxes + 0.5).reshape(b, nb, 2, 2)
    size = cfg.prompt.input_image_size
    emb = _fourier_pos_encode(corners / size, sd[SHARED_PE])
    offs = torch.stack([_embed_row(sd, "point_embed.2"),
                        _embed_row(sd, "point_embed.3")]).to(emb.dtype)
    return emb + offs[None, None]


def embed_mask_input(sd, masks, cfg: SamConfig):
    """masks (B, H, W, 1) NHWC low-res mask input -> dense (B, G, G, C):
    a stride-2 conv, LayerNorm (f32), GELU, a stride-2 conv, LayerNorm,
    GELU and a 1x1 conv, in masks' dtype. Each conv is ``F.conv2d`` on the
    HF (out, in, kh, kw) weight without its bias, the bias added after the
    conv's rounding to masks' dtype, as the JAX package adds it."""
    pf = "prompt_encoder.mask_embed"
    eps = cfg.prompt.layer_norm_eps

    def conv(x, name, stride):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     sd[f"{pf}.{name}.weight"].to(x.dtype), stride=stride)
        return y.permute(0, 2, 3, 1) + sd[f"{pf}.{name}.bias"].to(x.dtype)

    x = conv(masks, "conv1", 2)
    x = gelu(layer_norm(x, sd, f"{pf}.layer_norm1", eps))
    x = conv(x, "conv2", 2)
    x = gelu(layer_norm(x, sd, f"{pf}.layer_norm2", eps))
    return conv(x, "conv3", 1)


def encode_prompts(sd, cfg: SamConfig, batch_size: int, points=None,
                   labels=None, boxes=None, mask_inputs=None,
                   dtype=torch.float32):
    """Returns (sparse (B, P, T, C) or None, dense (B, G, G, C)). The dense
    prompt is ``embed_mask_input(mask_inputs)`` when a (B, 4G, 4G, 1) mask
    input is given, else the broadcast no-mask embedding."""
    sparse = None
    if points is not None:
        if labels is None:
            labels = torch.ones(points.shape[:-1], dtype=torch.int32,
                                device=points.device)
        sparse = embed_points(sd, points, labels, cfg, pad=boxes is None)
    if boxes is not None:
        box_emb = embed_boxes(sd, boxes, cfg)
        sparse = box_emb if sparse is None else torch.cat([sparse, box_emb], 2)
    g = cfg.prompt.image_embedding_size
    if mask_inputs is not None:
        dense = embed_mask_input(sd, mask_inputs, cfg).to(dtype)
    else:
        dense = _embed_row(sd, "no_mask_embed").to(dtype).expand(
            batch_size, g, g, cfg.prompt.hidden_size)
    if sparse is not None:
        sparse = sparse.to(dtype)
    return sparse, dense


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------


# The JAX package's decoder routing switches (``models/sam.py``
# ``set_fused_i2t`` / ``set_fused_upscaler``), with its four modes and rules.
# 'interpret' names the Pallas interpreter there; here it is the fused route
# under that mode's dtype rule: the kernel on a CUDA tensor, its plain
# version on a CPU tensor, never the plain version on the card.
_FUSED_MODES = ("auto", "on", "off", "interpret")
_FUSED_I2T = "auto"
_FUSED_UPSCALER = "auto"


def set_fused_i2t(mode: str):
    """mode in {'auto', 'on', 'off', 'interpret'} — the fused image→token
    cross-attention + residual + LayerNorm (``ops/decoder_attn.py``, K4):
    'auto' takes it in bf16, 'on' and 'interpret' in any dtype (f32
    included), 'off' never; every mode needs <= 8 tokens, heads dividing the
    width and one shared positional grid."""
    global _FUSED_I2T
    if mode not in _FUSED_MODES:
        raise ValueError(f"unknown fused-i2t mode {mode!r}")
    _FUSED_I2T = mode


def set_fused_upscaler(mode: str):
    """mode in {'auto', 'on', 'off', 'interpret'} — the fused upscaler and
    hypernetwork product (``ops/upscaler.py``, K3) of the blocked decode:
    'auto' takes it in bf16 on grids of >= 1024 cells, 'on' in bf16 at any
    grid (for other dtypes it warns and keeps the einsum chain, as the JAX
    package does), 'interpret' in any dtype (f32 included), 'off' never."""
    global _FUSED_UPSCALER
    if mode not in _FUSED_MODES:
        raise ValueError(f"unknown fused-upscaler mode {mode!r}")
    _FUSED_UPSCALER = mode


def _use_fused_i2t(dtype, n_tok: int, internal: int, nh: int,
                   pe_batch: int) -> bool:
    """The JAX package's ``_use_fused_i2t``; its 'auto' as on an
    accelerator."""
    if _FUSED_I2T == "off":
        return False
    if not (n_tok <= T_PAD and internal % nh == 0 and pe_batch == 1):
        return False
    if _FUSED_I2T in ("on", "interpret"):
        return True
    return dtype == torch.bfloat16


def _use_fused_upscaler(n_pixels: int, dtype) -> bool:
    """The JAX package's ``_use_fused_upscaler``; its 'auto' as on an
    accelerator (blocked decode only, checked by the caller)."""
    if _FUSED_UPSCALER == "off":
        return False
    if _FUSED_UPSCALER == "interpret":
        return True
    if dtype != torch.bfloat16:
        if _FUSED_UPSCALER == "on":
            warnings.warn(
                "set_fused_upscaler('on') ignored for non-bf16 inputs, as in "
                "the JAX package (whose f32 erf GELU has no Mosaic "
                "lowering): using the einsum chain (use 'interpret' to "
                "force the fused kernel)",
                stacklevel=3,
            )
        return False
    if _FUSED_UPSCALER == "on":
        return True
    return n_pixels >= 1024


def _heads(x, n_heads):
    """(B, N, nh*hd) → (B, nh, N, hd)."""
    b, n, c = x.shape
    return x.reshape(b, n, n_heads, c // n_heads).transpose(1, 2)


def _attend(qh, kh, vh):
    """softmax(q k^T / sqrt(hd)) v: q scaled in its dtype (the scale taken in
    that dtype, as JAX takes a Python scalar), f32 logits and softmax, the
    probabilities rounded to v's dtype, the product summed in f32 and
    rounded once."""
    hd = qh.shape[-1]
    if qh.dtype == torch.float32:
        logits = torch.matmul(qh * hd ** -0.5, kh.transpose(-1, -2))
        return torch.matmul(torch.softmax(logits, dim=-1), vh)
    qs = qh * torch.tensor(hd ** -0.5, dtype=qh.dtype, device=qh.device)
    logits = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
    attn = torch.softmax(logits, dim=-1).to(vh.dtype)
    return torch.matmul(attn.float(), vh.float()).to(vh.dtype)


def _decoder_attention(q, k, v, sd, prefix: str, n_heads: int):
    """SAM decoder attention; q/k/v (B, N, C_model) → (B, Nq, C_model)."""
    b, nq, _ = q.shape
    q = linear(q, sd, f"{prefix}.q_proj")
    k = linear(k, sd, f"{prefix}.k_proj")
    v = linear(v, sd, f"{prefix}.v_proj")
    internal = q.shape[-1]
    out = _attend(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads))
    out = out.transpose(1, 2).reshape(b, nq, internal)
    return linear(out, sd, f"{prefix}.out_proj")


def _mlp(x, sd, prefix):
    return linear(torch.relu(linear(x, sd, f"{prefix}.mlp.lin1")), sd,
                  f"{prefix}.mlp.lin2")


def two_way_block(queries, keys, query_pe, key_pe, sd, prefix: str,
                  cfg: DecoderConfig, first: bool):
    eps = cfg.layer_norm_eps
    nh = cfg.num_heads
    if first:
        # the first layer's self-attention REPLACES the queries (no residual,
        # no positional embedding)
        queries = _decoder_attention(queries, queries, queries, sd,
                                     f"{prefix}.self_attn", nh)
    else:
        q = queries + query_pe
        queries = queries + _decoder_attention(q, q, queries, sd,
                                               f"{prefix}.self_attn", nh)
    queries = layer_norm(queries, sd, f"{prefix}.layer_norm1", eps)

    q = queries + query_pe
    k = keys + key_pe
    queries = queries + _decoder_attention(
        q, k, keys, sd, f"{prefix}.cross_attn_token_to_image", nh)
    queries = layer_norm(queries, sd, f"{prefix}.layer_norm2", eps)
    queries = layer_norm(queries + _mlp(queries, sd, prefix), sd,
                         f"{prefix}.layer_norm3", eps)

    pf = f"{prefix}.cross_attn_image_to_token"
    if _use_fused_i2t(keys.dtype, queries.shape[1],
                      sd[f"{pf}.q_proj.weight"].shape[0], nh, key_pe.shape[0]):
        # fused per-row chain (ops/decoder_attn.py, K4): q projection,
        # <= 8-token attention, out projection, residual, LayerNorm
        tok = queries + query_pe
        keys = fused_i2t_ln(keys, key_pe, linear(tok, sd, f"{pf}.k_proj"),
                            linear(queries, sd, f"{pf}.v_proj"), sd, prefix,
                            nh=nh, pb=1, eps=eps)
        return queries, keys
    q = queries + query_pe
    k = keys + key_pe
    keys = keys + _decoder_attention(k, q, queries, sd, pf, nh)
    keys = layer_norm(keys, sd, f"{prefix}.layer_norm4", eps)
    return queries, keys


def _two_way_block_first_shared(queries, keys_img, query_pe, key_pe, sd,
                                prefix: str, cfg: DecoderConfig, pb: int):
    """Layer-1 variant with the image side still per-IMAGE (pb > 1).

    Until the first image→token residual lands, the image tensor is the
    same for an image's pb prompts, so its k/v projections (token→image)
    and q projection (image→token) run on (B, HW, C) rows instead of
    (B*pb, HW, C). Linear maps commute with the repeat, so the math equals
    repeating first."""
    eps = cfg.layer_norm_eps
    nh = cfg.num_heads
    b, hw, c = keys_img.shape
    bp, t, _ = queries.shape

    queries = _decoder_attention(queries, queries, queries, sd,
                                 f"{prefix}.self_attn", nh)
    queries = layer_norm(queries, sd, f"{prefix}.layer_norm1", eps)

    # token→image cross-attention, shared k/v projections
    pf = f"{prefix}.cross_attn_token_to_image"
    q = queries + query_pe  # (BP, T, C)
    k_img = keys_img + key_pe  # (B, HW, C)
    qp = linear(q, sd, f"{pf}.q_proj").reshape(b, pb * t, -1)
    internal = qp.shape[-1]
    out = _attend(_heads(qp, nh), _heads(linear(k_img, sd, f"{pf}.k_proj"), nh),
                  _heads(linear(keys_img, sd, f"{pf}.v_proj"), nh))
    out = out.transpose(1, 2).reshape(bp, t, internal)
    queries = queries + linear(out, sd, f"{pf}.out_proj")
    queries = layer_norm(queries, sd, f"{prefix}.layer_norm2", eps)
    queries = layer_norm(queries + _mlp(queries, sd, prefix), sd,
                         f"{prefix}.layer_norm3", eps)

    # image→token cross-attention, shared q projection
    pf = f"{prefix}.cross_attn_image_to_token"
    tok = queries + query_pe
    if _use_fused_i2t(keys_img.dtype, t, sd[f"{pf}.q_proj.weight"].shape[0],
                      nh, key_pe.shape[0]):
        # fused per-row chain (K4); keys stay per IMAGE at the kernel input
        # and the per-pair tensor first exists as the kernel's output
        keys = fused_i2t_ln(keys_img, key_pe, linear(tok, sd, f"{pf}.k_proj"),
                            linear(queries, sd, f"{pf}.v_proj"), sd, prefix,
                            nh=nh, pb=pb, eps=eps)
        return queries, keys
    qh = _heads(linear(k_img, sd, f"{pf}.q_proj"), nh)  # (B, nh, HW, hd)
    hd = qh.shape[-1]
    kh = linear(tok, sd, f"{pf}.k_proj").reshape(b, pb, t, nh, hd).transpose(2, 3)
    vh = linear(queries, sd, f"{pf}.v_proj").reshape(b, pb, t, nh, hd
                                                      ).transpose(2, 3)
    out = _attend(qh[:, None], kh, vh)  # (B, pb, nh, HW, hd), q broadcast
    out = out.permute(0, 1, 3, 2, 4).reshape(bp, hw, internal)
    keys = (keys_img[:, None] + linear(out, sd, f"{pf}.out_proj").reshape(
        b, pb, hw, c)).reshape(bp, hw, c)
    keys = layer_norm(keys, sd, f"{prefix}.layer_norm4", eps)
    return queries, keys


def two_way_transformer(point_emb, image_emb, image_pe, sd,
                        cfg: DecoderConfig, pb: int = 1):
    """point_emb (BP, T, C); image_pe broadcastable (1 or BP, HW, C);
    image_emb (BP, HW, C), or (B, HW, C) per image when pb > 1."""
    pf = "mask_decoder.transformer"
    queries, keys = point_emb, image_emb
    for i in range(cfg.num_layers):
        if i == 0 and pb > 1:
            queries, keys = _two_way_block_first_shared(
                queries, keys, point_emb, image_pe, sd, f"{pf}.layers.0", cfg,
                pb)
            continue
        queries, keys = two_way_block(queries, keys, point_emb, image_pe, sd,
                                      f"{pf}.layers.{i}", cfg, first=(i == 0))
    q = queries + point_emb
    k = keys + image_pe
    queries = queries + _decoder_attention(
        q, k, keys, sd, f"{pf}.final_attn_token_to_image", cfg.num_heads)
    # HF's final LayerNorm uses torch's default eps 1e-5
    queries = layer_norm(queries, sd, f"{pf}.layer_norm_final_attn", 1e-5)
    return queries, keys


def _convt_weight(sd, n: int, dtype):
    """HF transposed-conv weight (in, out, 2, 2) → (in, 2, 2, out)."""
    return sd[f"mask_decoder.upscale_conv{n}.weight"].permute(0, 2, 3, 1).to(dtype)


def _upscale2x(x, w, b):
    """2x2-stride-2 transposed conv as einsum + reshape (no overlap):
    x (B, H, W, Ci), w (Ci, 2, 2, Co) → (B, 2H, 2W, Co)."""
    bsz, h, ww, _ = x.shape
    co = w.shape[-1]
    y = torch.einsum("bhwc,cdeo->bhdweo", x, w)
    return y.reshape(bsz, 2 * h, 2 * ww, co) + b.to(y.dtype)


def _hyper_mlps(sd, tokens, n_mask_tokens: int):
    """The per-mask-token hypernetwork MLPs, stacked: (BP, M, C) →
    (BP, M, C/8)."""
    pf = "mask_decoder.output_hypernetworks_mlps"

    def stacked(name):
        w = torch.stack([sd[f"{pf}.{i}.{name}.weight"]
                         for i in range(n_mask_tokens)]).to(tokens.dtype)
        b = torch.stack([sd[f"{pf}.{i}.{name}.bias"]
                         for i in range(n_mask_tokens)]).to(tokens.dtype)
        return w, b

    h = tokens
    for name, act in (("proj_in", True), ("layers.0", True), ("proj_out", False)):
        w, b = stacked(name)
        h = torch.einsum("btc,tdc->btd", h, w) + b
        if act:
            h = torch.relu(h)
    return h


def decode_masks(sd, cfg: SamConfig, image_embeddings, image_pe,
                 sparse_prompt, dense_prompt, multimask_output: bool = False,
                 blocked: bool = False):
    """image_embeddings (B, G, G, C) NHWC (dense prompt not yet added),
    image_pe (G, G, C), sparse_prompt (B, P, T, C) or None, dense_prompt
    (B, G, G, C). Returns (masks (B, P, M, 4G, 4G), iou_pred (B, P, M)).

    blocked=True returns masks as (B, P, M, G, G, 2, 2, 2, 2): pixel
    (4h+2d+f, 4w+2e+g) at [h, w, d, e, f, g], the upscaler's own block order,
    which ops/postprocess.postprocess_masks_blocked consumes directly."""
    d = cfg.decoder
    b, g, _, c = image_embeddings.shape
    pb = sparse_prompt.shape[1] if sparse_prompt is not None else 1

    out_tokens = torch.cat([sd["mask_decoder.iou_token.weight"],
                            sd["mask_decoder.mask_tokens.weight"]], dim=0)
    out_tokens = out_tokens.to(image_embeddings.dtype).expand(
        b, pb, out_tokens.shape[0], c)
    tokens = (torch.cat([out_tokens, sparse_prompt], dim=2)
              if sparse_prompt is not None else out_tokens)
    n_tok = tokens.shape[2]

    src = (image_embeddings + dense_prompt).reshape(b, g * g, c)
    pe = image_pe.reshape(1, g * g, c).to(src.dtype)
    # pb > 1: src stays per IMAGE; the repeat to (B*pb, HW, C) happens inside
    # layer 1 at the first image→token residual
    queries, keys = two_way_transformer(tokens.reshape(b * pb, n_tok, c), src,
                                        pe, sd, d, pb=pb)
    iou_token_out = queries[:, 0, :]
    mask_tokens_out = queries[:, 1:1 + d.num_mask_tokens, :]

    hyper_in = _hyper_mlps(sd, mask_tokens_out, d.num_mask_tokens)
    # slice the requested mask tokens BEFORE the per-pixel product
    sl = slice(1, None) if multimask_output else slice(0, 1)
    hyper_sl = hyper_in[:, sl]
    n_out = hyper_sl.shape[1]

    up = keys.reshape(b * pb, g, g, c)
    ct1_b = sd["mask_decoder.upscale_conv1.bias"].to(up.dtype)
    ct2_b = sd["mask_decoder.upscale_conv2.bias"].to(up.dtype)
    if blocked and _use_fused_upscaler(g * g, up.dtype):
        # fused chain (ops/upscaler.py, K3): the (BP, 4G, 4G, C/8) second
        # upscale never exists; output lanes (t, d, e, f, g)
        mf = upscale_hyper_masks(up.reshape(b * pb, g * g, c), sd, hyper_sl)
        mf = mf.reshape(b, pb, g, g, n_out, 2, 2, 2, 2)
        masks = torch.movedim(mf, 4, 2)
    elif blocked:
        u1 = torch.einsum("bhwc,cdeo->bhwdeo", up,
                          _convt_weight(sd, 1, up.dtype)) + ct1_b
        u1 = gelu(layer_norm(u1, sd, "mask_decoder.upscale_layer_norm", 1e-6))
        u2 = torch.einsum("bhwdec,cfgo->bhwdefgo", u1,
                          _convt_weight(sd, 2, up.dtype))
        u2 = gelu(u2 + ct2_b)
        masks = torch.einsum("btc,bhwdefgc->bthwdefg", hyper_sl.float(),
                             u2.float())
        masks = masks.reshape(b, pb, n_out, g, g, 2, 2, 2, 2)
    else:
        up = _upscale2x(up, _convt_weight(sd, 1, up.dtype), ct1_b)
        up = gelu(layer_norm(up, sd, "mask_decoder.upscale_layer_norm", 1e-6))
        up = gelu(_upscale2x(up, _convt_weight(sd, 2, up.dtype), ct2_b))
        g4 = 4 * g
        masks = torch.einsum("btc,bpc->btp", hyper_sl.float(),
                             up.reshape(b * pb, g4 * g4, -1).float())
        masks = masks.reshape(b, pb, n_out, g4, g4)

    y = iou_token_out
    pf = "mask_decoder.iou_prediction_head"
    names = (["proj_in"] + [f"layers.{i}" for i in range(d.iou_head_depth - 2)]
             + ["proj_out"])
    for name in names[:-1]:
        y = torch.relu(linear(y, sd, f"{pf}.{name}"))
    iou_pred = linear(y, sd, f"{pf}.{names[-1]}").reshape(b, pb,
                                                           d.num_mask_tokens)
    return masks, iou_pred[:, :, sl]


# ---------------------------------------------------------------------------
# End-to-end forward
# ---------------------------------------------------------------------------


def sam_forward(sd, cfg: SamConfig, pixel_values=None, image_embeddings=None,
                points=None, labels=None, boxes=None, mask_inputs=None,
                multimask_output: bool = False):
    """Full SAM forward (HF ``SamModel.forward``'s contract, NHWC tensors;
    ``mask_inputs`` (B, 4G, 4G, 1) low-res masks, as HF's
    ``input_masks``); pred_masks are the low-res logits before the
    postprocess."""
    if image_embeddings is None:
        image_embeddings = encode_image(sd, pixel_values, cfg)
    b = image_embeddings.shape[0]
    sparse, dense = encode_prompts(sd, cfg, b, points=points, labels=labels,
                                   boxes=boxes, mask_inputs=mask_inputs,
                                   dtype=image_embeddings.dtype)
    pe = image_wide_pe(sd, cfg)
    masks, iou = decode_masks(sd, cfg, image_embeddings, pe, sparse, dense,
                              multimask_output)
    return {"pred_masks": masks, "iou_scores": iou,
            "image_embeddings": image_embeddings}


# ---------------------------------------------------------------------------
# Random initialisation (tests, smoke runs)
# ---------------------------------------------------------------------------


def init_params(cfg: SamConfig, generator: torch.Generator) -> dict:
    """Random HF-named state_dict on the host (the JAX package's scales:
    N(0, 0.02) weights, zero biases, unit LayerNorms, zero rel-pos tables).
    The numbers differ from JAX's ``init_params`` for the same seed."""
    v, pr, d = cfg.vision, cfg.prompt, cfg.decoder

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=generator) * std

    def lin(d_in, d_out):
        return {"w": normal(d_in, d_out), "b": torch.zeros(d_out)}

    def ln(dim):
        return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}

    def attn(downsample):
        internal = d.hidden_size // downsample
        return {"q": lin(d.hidden_size, internal),
                "k": lin(d.hidden_size, internal),
                "v": lin(d.hidden_size, internal),
                "out": lin(internal, d.hidden_size)}

    layers = []
    for i in range(v.num_layers):
        ws = v.window_size if i not in v.global_attn_indexes else v.grid_size
        layers.append({
            "ln1": ln(v.hidden_size),
            "attn": {"qkv": lin(v.hidden_size, 3 * v.hidden_size),
                     "proj": lin(v.hidden_size, v.hidden_size),
                     "rel_pos_h": torch.zeros(2 * ws - 1, v.head_dim),
                     "rel_pos_w": torch.zeros(2 * ws - 1, v.head_dim)},
            "ln2": ln(v.hidden_size),
            "mlp1": lin(v.hidden_size, v.mlp_dim),
            "mlp2": lin(v.mlp_dim, v.hidden_size),
        })
    mic = pr.mask_input_channels

    def conv(kh, kw, ci, co):
        return {"w": normal(kh, kw, ci, co), "b": torch.zeros(co)}

    nmt, c8 = d.num_mask_tokens, d.hidden_size // 8
    dims = ([d.hidden_size] + [d.iou_head_hidden_dim] * (d.iou_head_depth - 1)
            + [nmt])
    tree = {
        "vision": {
            "patch_embed": {"w": normal(v.patch_size, v.patch_size,
                                        v.num_channels, v.hidden_size),
                            "b": torch.zeros(v.hidden_size)},
            "pos_embed": torch.zeros(1, v.grid_size, v.grid_size,
                                     v.hidden_size),
            "layers": layers,
            "neck": {"conv1_w": normal(v.hidden_size, v.output_channels),
                     "ln1": ln(v.output_channels),
                     "conv2_w": normal(3, 3, v.output_channels,
                                       v.output_channels),
                     "ln2": ln(v.output_channels)},
        },
        "prompt": {
            "point_embed": normal(pr.num_point_embeddings, pr.hidden_size),
            "not_a_point": normal(pr.hidden_size),
            "no_mask": normal(pr.hidden_size),
            "mask_embed": {"conv1": conv(2, 2, 1, mic // 4), "ln1": ln(mic // 4),
                           "conv2": conv(2, 2, mic // 4, mic), "ln2": ln(mic),
                           "conv3": conv(1, 1, mic, pr.hidden_size)},
        },
        "decoder": {
            "iou_token": normal(1, d.hidden_size),
            "mask_tokens": normal(nmt, d.hidden_size),
            "transformer": {
                "layers": [{
                    "self_attn": attn(1), "ln1": ln(d.hidden_size),
                    "cross_t2i": attn(d.attention_downsample_rate),
                    "ln2": ln(d.hidden_size),
                    "mlp1": lin(d.hidden_size, d.mlp_dim),
                    "mlp2": lin(d.mlp_dim, d.hidden_size),
                    "ln3": ln(d.hidden_size),
                    "cross_i2t": attn(d.attention_downsample_rate),
                    "ln4": ln(d.hidden_size),
                } for _ in range(d.num_layers)],
                "final_attn": attn(d.attention_downsample_rate),
                "ln_final": ln(d.hidden_size),
            },
            "upscale": {
                "ct1_w": normal(d.hidden_size, 2, 2, d.hidden_size // 4),
                "ct1_b": torch.zeros(d.hidden_size // 4),
                "ln": ln(d.hidden_size // 4),
                "ct2_w": normal(d.hidden_size // 4, 2, 2, c8),
                "ct2_b": torch.zeros(c8),
            },
            "hyper": {"w1": normal(nmt, d.hidden_size, d.hidden_size),
                      "b1": torch.zeros(nmt, d.hidden_size),
                      "w2": normal(nmt, d.hidden_size, d.hidden_size),
                      "b2": torch.zeros(nmt, d.hidden_size),
                      "w3": normal(nmt, d.hidden_size, c8),
                      "b3": torch.zeros(nmt, c8)},
            "iou_head": {f"l{i}": lin(dims[i], dims[i + 1])
                         for i in range(d.iou_head_depth)},
        },
        "shared_pe": normal(2, cfg.num_pos_feats,
                            std=(pr.hidden_size // 2) ** 0.5),
    }
    return params_from_jax(tree)
