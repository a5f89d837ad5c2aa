"""The port's parameters: an HF ``SamModel`` state_dict, by name and layout.

The port keeps its weights exactly as HF ``transformers.SamModel`` names and
lays them out, so the reference's fine-tuned ``.pt`` checkpoints and
``tests/fixtures/sam_golden.npz`` load with no mapping at all:

  * ``nn.Linear`` weights are (out, in);
  * conv weights are (out, in, kh, kw); transposed-conv weights are
    (in, out, kh, kw);
  * the hypernetwork MLPs are five separate modules (not stacked).

``params_from_jax`` bridges from the JAX package's parameter tree (given as
numpy arrays) for the parity tests; it re-implements
``dilabhelmholtzoct_tpu/models/convert.py::to_hf_state_dict`` without
importing it.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    # f32 copy on the host: the tree's buffers are never aliased
    return torch.tensor(np.asarray(x, dtype=np.float32))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → the port's HF-named state_dict.

    The (in, out) linear layout is transposed to (out, in), HWIO convs to
    OIHW, (in, kh, kw, out) transposed convs to (in, out, kh, kw), and the
    stacked hypernetwork weights are split per mask token. Counts (point
    embeddings, mask tokens, iou-head depth) are read from the tree.
    """
    sd: dict[str, torch.Tensor] = {}

    def put_lin(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
        sd[f"{prefix}.bias"] = _t(p["b"])

    def put_ln(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])

    def put_attn(prefix, p):
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            put_lin(f"{prefix}.{hf}", p[ours])

    def put_conv(name, w):  # HWIO → OIHW
        sd[name] = _t(w).permute(3, 2, 0, 1).contiguous()

    v = tree["vision"]
    put_conv("vision_encoder.patch_embed.projection.weight",
             v["patch_embed"]["w"])
    sd["vision_encoder.patch_embed.projection.bias"] = _t(v["patch_embed"]["b"])
    sd["vision_encoder.pos_embed"] = _t(v["pos_embed"])
    for i, lp in enumerate(v["layers"]):
        pf = f"vision_encoder.layers.{i}"
        put_ln(f"{pf}.layer_norm1", lp["ln1"])
        put_lin(f"{pf}.attn.qkv", lp["attn"]["qkv"])
        put_lin(f"{pf}.attn.proj", lp["attn"]["proj"])
        sd[f"{pf}.attn.rel_pos_h"] = _t(lp["attn"]["rel_pos_h"])
        sd[f"{pf}.attn.rel_pos_w"] = _t(lp["attn"]["rel_pos_w"])
        put_ln(f"{pf}.layer_norm2", lp["ln2"])
        put_lin(f"{pf}.mlp.lin1", lp["mlp1"])
        put_lin(f"{pf}.mlp.lin2", lp["mlp2"])
    neck = v["neck"]
    sd["vision_encoder.neck.conv1.weight"] = (
        _t(neck["conv1_w"]).T[:, :, None, None].contiguous())
    put_ln("vision_encoder.neck.layer_norm1", neck["ln1"])
    put_conv("vision_encoder.neck.conv2.weight", neck["conv2_w"])
    put_ln("vision_encoder.neck.layer_norm2", neck["ln2"])

    pr = tree["prompt"]
    for i, row in enumerate(np.asarray(pr["point_embed"])):
        sd[f"prompt_encoder.point_embed.{i}.weight"] = _t(row)[None]
    sd["prompt_encoder.not_a_point_embed.weight"] = _t(pr["not_a_point"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = _t(pr["no_mask"])[None]
    for name in ("conv1", "conv2", "conv3"):
        put_conv(f"prompt_encoder.mask_embed.{name}.weight",
                 pr["mask_embed"][name]["w"])
        sd[f"prompt_encoder.mask_embed.{name}.bias"] = _t(
            pr["mask_embed"][name]["b"])
    put_ln("prompt_encoder.mask_embed.layer_norm1", pr["mask_embed"]["ln1"])
    put_ln("prompt_encoder.mask_embed.layer_norm2", pr["mask_embed"]["ln2"])

    d = tree["decoder"]
    sd["mask_decoder.iou_token.weight"] = _t(d["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = _t(d["mask_tokens"])
    for i, lp in enumerate(d["transformer"]["layers"]):
        pf = f"mask_decoder.transformer.layers.{i}"
        put_attn(f"{pf}.self_attn", lp["self_attn"])
        put_ln(f"{pf}.layer_norm1", lp["ln1"])
        put_attn(f"{pf}.cross_attn_token_to_image", lp["cross_t2i"])
        put_ln(f"{pf}.layer_norm2", lp["ln2"])
        put_lin(f"{pf}.mlp.lin1", lp["mlp1"])
        put_lin(f"{pf}.mlp.lin2", lp["mlp2"])
        put_ln(f"{pf}.layer_norm3", lp["ln3"])
        put_attn(f"{pf}.cross_attn_image_to_token", lp["cross_i2t"])
        put_ln(f"{pf}.layer_norm4", lp["ln4"])
    put_attn("mask_decoder.transformer.final_attn_token_to_image",
             d["transformer"]["final_attn"])
    put_ln("mask_decoder.transformer.layer_norm_final_attn",
           d["transformer"]["ln_final"])
    up = d["upscale"]
    for n in ("1", "2"):  # (in, kh, kw, out) → (in, out, kh, kw)
        sd[f"mask_decoder.upscale_conv{n}.weight"] = (
            _t(up[f"ct{n}_w"]).permute(0, 3, 1, 2).contiguous())
        sd[f"mask_decoder.upscale_conv{n}.bias"] = _t(up[f"ct{n}_b"])
    put_ln("mask_decoder.upscale_layer_norm", up["ln"])
    h = d["hyper"]
    for i in range(np.asarray(h["w1"]).shape[0]):
        pf = f"mask_decoder.output_hypernetworks_mlps.{i}"
        for name, w, b in (("proj_in", "w1", "b1"), ("layers.0", "w2", "b2"),
                           ("proj_out", "w3", "b3")):
            put_lin(f"{pf}.{name}", {"w": np.asarray(h[w])[i],
                                     "b": np.asarray(h[b])[i]})
    ih = d["iou_head"]
    depth = len(ih)
    put_lin("mask_decoder.iou_prediction_head.proj_in", ih["l0"])
    for i in range(1, depth - 1):
        put_lin(f"mask_decoder.iou_prediction_head.layers.{i - 1}", ih[f"l{i}"])
    put_lin("mask_decoder.iou_prediction_head.proj_out", ih[f"l{depth - 1}"])

    sd["shared_image_embedding.positional_embedding"] = _t(tree["shared_pe"])
    sd["prompt_encoder.shared_embedding.positional_embedding"] = _t(
        tree["shared_pe"])
    return sd


def load_state_dict(path: str, *,
                    allow_pickled_module: bool = False) -> dict[str, torch.Tensor]:
    """Load a torch ``.pt``/``.pth``/``.bin`` or a ``.safetensors`` file as an
    f32 state_dict on the host.

    ``allow_pickled_module=True`` also accepts a whole pickled ``nn.Module``
    (the organoid sister project's checkpoint format). Unpickling can run
    arbitrary code, so it is opt-in; plain state_dicts never need it.
    """
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} needs the 'safetensors' package, which is "
                "not installed; save the checkpoint as .pt instead") from e
        sd = load_file(path, device="cpu")
    else:
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            if not allow_pickled_module:
                raise
            # a whole-module pickle: weights_only refuses it by design
            sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in sd.items()}
