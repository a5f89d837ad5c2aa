"""Interactive OCT segmentation web app (Gradio) on the PyTorch engine.

Port of ``dilabhelmholtzoct_tpu/inference/app.py``: an ImagePrompter input
(click = point prompt, drag = box prompt) and an AnnotatedImage output with
the mask red, the box green and the point blue.

Run:
    python -m dilabhelmholtzoct_tpu_torch.inference.app \
        --base_model facebook/sam-vit-base \
        --checkpoint /path/to/finetuned.pt [--share] [--device cuda]

Gradio is optional and imported only by ``main``; ``segment_event`` works
without it. ``inference/app_organoid.py`` is the same app with whole-pickled
``.pth`` checkpoints accepted by default.
"""

from __future__ import annotations

import argparse

from .engine import SegmentationEngine, parse_image_prompter_points, point_marker


def segment_event(engine: SegmentationEngine, inputs: dict):
    """One ImagePrompter event {'image', 'points'} → (image,
    [(mask_or_region, label), ...]) in AnnotatedImage's format."""
    if not inputs or inputs.get("image") is None:
        # submit before an image is uploaded: an empty annotation, not a
        # TypeError banner in the UI
        return None, []
    img = inputs["image"]
    masks = []
    for prompt_type, prompt in parse_image_prompter_points(
            inputs.get("points") or []):
        binary, _ = engine.segment(img, prompt, prompt_type, with_probs=False)
        if prompt_type == "points":
            masks.append(
                (point_marker(img.shape[:2], prompt[0], prompt[1]), "point"))
        else:
            masks.append((prompt, "box"))
        masks.append((binary[0], "mask"))
    return img, masks


def build_demo(engine: SegmentationEngine):
    import gradio as gr
    from gradio_image_prompter import ImagePrompter

    return gr.Interface(
        lambda inputs: segment_event(engine, inputs),
        ImagePrompter(show_label=True),
        [gr.AnnotatedImage(
            color_map={"mask": "#ff0000", "box": "#00ff00", "point": "#0000ff"}
        )],
    )


def main(argv=None, *, allow_pickled_module_default: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_model", type=str,
                        default="facebook/sam-vit-base")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="fine-tuned .pt/.pth/.safetensors (local)")
    parser.add_argument("--share", action="store_true",
                        help="public Gradio tunnel (opt-in)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--allow_pickled_module", action="store_true",
                        default=allow_pickled_module_default,
                        help="accept whole-pickled-module .pth checkpoints; "
                             "pickles can execute code, so opt-in")
    args = parser.parse_args(argv)

    engine = SegmentationEngine.from_checkpoint(
        args.base_model, args.checkpoint,
        allow_pickled_module=args.allow_pickled_module, device=args.device,
    )
    try:
        demo = build_demo(engine)
    except ImportError as e:
        raise SystemExit(
            f"gradio/gradio_image_prompter not installed ({e}); the engine "
            "is importable as dilabhelmholtzoct_tpu_torch.inference.engine"
        )
    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
