"""CLI helpers, the port's copy of the JAX package's `yolox_tpu/cli/utils.py`.

`resolve_config`: a named config (hyphen/underscore tolerant) or a
`module:ClassName` path to a user subclass of the port's `YoloxConfig`.
`parse_model_config_opts`: `-D key=value` pairs -> dict.
`add_device_flag`: the port's `--device` flag; `refuse_multi_process_flags`:
the flags that need several processes raise.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from yolox_tpu_torch.config import YoloxConfig


def resolve_config(name: str) -> YoloxConfig:
    config = YoloxConfig.get_named_config(name)
    if config is not None:
        return config
    if ":" in name:
        module_name, class_name = name.rsplit(":", 1)
        module = importlib.import_module(module_name)
        cls = getattr(module, class_name, None)
        if cls is None or not (isinstance(cls, type)
                               and issubclass(cls, YoloxConfig)):
            raise ValueError(
                f"{name} is not a YoloxConfig subclass")
        return cls()
    raise ValueError(f"Unknown model config: {name}")


def parse_model_config_opts(opts: Optional[List[str]]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for opt in opts or []:
        if "=" not in opt:
            raise ValueError(
                f"Invalid -D option {opt!r}; expected key=value")
        k, v = opt.split("=", 1)
        out[k] = v
    return out


def add_device_flag(parser) -> None:
    """`--device {cuda,cpu}`: the CUDA card unless the CPU is asked for;
    with no card and no flag the command raises."""
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="device to run on (default: the CUDA card; "
                             "cpu runs the kernels' plain versions)")


def refuse_multi_process_flags(args) -> None:
    """Refuse the flags that need several processes: data-parallel
    training and evaluation come with a later slice of the port."""
    several = (getattr(args, "num_machines", 1) > 1
               or (getattr(args, "devices", None) or 1) > 1
               or getattr(args, "dist_url", None) is not None)
    if several:
        raise NotImplementedError(
            "--num_machines > 1, -d > 1 and --dist-url need several "
            "processes (torch.distributed), which yolox_tpu_torch does not "
            "have yet: ROADMAP.md M7, second slice (data-parallel "
            "training); run in one process on one device")
