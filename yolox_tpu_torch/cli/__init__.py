"""The `yolox-tpu-torch` command, the PyTorch port's counterpart of the JAX
package's `yolox-tpu` (`yolox_tpu/cli/`), flag for flag:

    yolox-tpu-torch train -c yolox-s -b 64 ...
    yolox-tpu-torch eval  -c yolox-s --ckpt ...

Every command runs on the CUDA card; `--device cpu` runs it on the CPU
(the kernels' plain versions), and with no card and no `--device` a
command raises.
"""

from __future__ import annotations

import sys

from yolox_tpu_torch.version import __version__

COMMANDS = ("train", "eval", "demo", "export", "visualize-assign")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        import importlib

        mod = importlib.import_module(
            "yolox_tpu_torch.cli." + argv[0].replace("-", "_"))
        return mod.main(argv[1:]) or 0
    if argv and argv[0] in ("-h", "--help"):
        _print_help()
        return 0
    print(f"yolox-tpu-torch {__version__}")
    _print_help()
    return 0 if not argv else 1


def _print_help():
    print(
        "usage: yolox-tpu-torch <command> [args]\n\n"
        "commands:\n"
        "  train    train a model (see `yolox-tpu-torch train -h`)\n"
        "  eval     evaluate a model (see `yolox-tpu-torch eval -h`)\n"
        "  demo     run inference on images/video (see "
        "`yolox-tpu-torch demo -h`)\n"
        "  export   export a model as a torch.export program (see "
        "`yolox-tpu-torch export -h`)\n"
        "  visualize-assign\n"
        "           draw SimOTA assignments for training batches\n\n"
        "every command takes --device {cuda,cpu} (default: the CUDA card)\n"
    )
