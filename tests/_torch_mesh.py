"""The gloo ranks of the port's serving-mesh test (`tests/test_torch_mesh.py`).

Nothing here imports JAX: the spawned ranks run the port alone, and the
parent test holds their results to one process and to the JAX package. A
rank reads the cases from `<root>/inputs.pkl` and writes what it returned
to `<root>/rank<r>.pkl`.
"""

from __future__ import annotations

import os
import pickle

import torch

WORLD = 8
SIZE = 128
SEED = 0          # nano's weights, as the JAX package's mesh tests
V3_SEED = 5


def nano():
    """yolox-nano from seed `SEED` on the CPU."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule

    cfg = YoloxConfig.get_named_config("yolox_nano")
    return YoloxModule.from_config(cfg, rng_seed=SEED, device="cpu")


def yolov3_21():
    """yolov3 on Darknet-21 (`tests/test_torch_yolov3.py`'s), seed
    `V3_SEED`, on the CPU."""
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.models.head import YoloxHead
    from yolox_tpu_torch.models.yolo_fpn import YoloFpn

    module = YoloxModule(YoloFpn(depth=21), YoloxHead(
        80, 1.0, in_channels=(128, 256, 512), act="lrelu"))
    module.init_params(V3_SEED)
    return module


def mesh_rank(rank, root):
    """One of `WORLD` gloo ranks: every case of `inputs.pkl` (name, model,
    (n_data, n_space) or ("data", n), the global batch, serving kwargs)
    through `make_serving_fn(mesh=...)`; each mesh is made on every rank
    (its groups are collective), served on its members."""
    from tests._torch_threads import cpu_share
    from yolox_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(max(1, cpu_share() // WORLD))
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    pm.init_distributed("gloo", f"file://{root}/rendezvous", WORLD, rank)
    out = {"rank": rank}
    models = {}
    try:
        for name, model, shape, x, kw in inp["cases"]:
            mesh = pm.data_parallel_mesh(shape[1]) if shape[0] == "data" \
                else pm.serving_mesh(*shape)
            if mesh.coords is None:
                continue
            if model not in models:
                models[model] = nano() if model == "nano" else yolov3_21()
                if model in inp["params"]:
                    models[model].load_params(inp["params"][model],
                                              strict=False)
            fn = models[model].make_serving_fn(mesh=mesh, **kw)
            dets, valid = fn(x)
            out[name] = {"dets": dets.numpy(), "valid": valid.numpy(),
                         "stats": fn.stats, "coords": mesh.coords}
    finally:
        pm.destroy_distributed()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
