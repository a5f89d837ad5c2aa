"""Organoid-variant inference app on the PyTorch engine.

Port of ``dilabhelmholtzoct_tpu/inference/app_organoid.py`` (the reference's
``app_organoid.py``): the UI of ``inference/app.py``; the one difference is
the checkpoint format. The organoid project saves its model as a whole
pickled module (``torch.save(model)``), so this variant accepts such
``.pth`` files by default (``--allow_pickled_module`` on; pickles can
execute code, so load only checkpoints you trust).

Run:
    python -m dilabhelmholtzoct_tpu_torch.inference.app_organoid \
        --checkpoint /path/to/organoid.pth [--share] [--device cuda]
"""

from __future__ import annotations

from .app import main as _main


def main(argv=None):
    return _main(argv, allow_pickled_module_default=True)


if __name__ == "__main__":
    main()
