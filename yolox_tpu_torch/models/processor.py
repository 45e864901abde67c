"""YoloxProcessor, the PyTorch port's counterpart of the JAX package's
`yolox_tpu/models/processor.py`.

Pre: per-image letterbox to `config.test_size` (114 padding at the
top-left, no normalization, RGB as `np.asarray(PIL image)` gives it); out
comes an NHWC batch. HWC uint8 numpy frames go in as they are, without
Pillow.

Post: confidence filter + class-aware NMS on the device
(`yolox_tpu_torch/ops/nms.py`), then rescale by 1 / letterbox ratio;
score = obj_conf * cls_conf; returns `Detections` dicts.
"""

from __future__ import annotations

from typing import Iterable, List, TypedDict, Union

import numpy as np

from yolox_tpu_torch.config import YoloxConfig
from yolox_tpu_torch.ops.preproc import letterbox_ratio, preproc
from yolox_tpu_torch.utils.trace import span


class Detections(TypedDict):
    bboxes: List[tuple]
    scores: List[float]
    labels: List[int]


class YoloxProcessor:
    config: YoloxConfig

    def __init__(self, model_name_or_config: Union[str, YoloxConfig]):
        if isinstance(model_name_or_config, str):
            config = YoloxConfig.get_named_config(model_name_or_config)
            if config is None:
                raise ValueError(f"Unknown model: {model_name_or_config}")
            self.config = config
        elif isinstance(model_name_or_config, YoloxConfig):
            self.config = model_name_or_config
        else:
            raise ValueError(
                "model_name_or_config must be a string or YoloxConfig")

    def __call__(self, inputs: Iterable, dtype=np.float32) -> np.ndarray:
        """PIL images or HWC arrays -> letterboxed NHWC batch in `dtype`
        (float32 as in the JAX package, or uint8 with the same values)."""
        with span("yolox.letterbox"):
            return np.stack([preproc(np.asarray(image), self.config.test_size,
                                     dtype=dtype)[0] for image in inputs])

    def postprocess(self, images: Iterable, tensor,
                    threshold: float = 0.5) -> List[Detections]:
        import torch

        from yolox_tpu_torch.ops.nms import postprocess_device

        dets, valid = postprocess_device(
            torch.as_tensor(tensor), self.config.num_classes, conf_thre=threshold,
            nms_thre=self.config.nmsthre, class_agnostic=False)
        return self.postprocess_dets(images, dets.cpu().numpy(),
                                     valid.cpu().numpy())

    def postprocess_dets(self, images: Iterable, dets: np.ndarray,
                         valid: np.ndarray) -> List[Detections]:
        """Rescale fixed-shape detections (from `postprocess_device` or the
        fused `YoloxModule.serve`) into Detections dicts."""
        results: List[Detections] = []
        for i, image in enumerate(images):
            if hasattr(image, "height"):
                h, w = image.height, image.width
            else:
                h, w = np.asarray(image).shape[:2]
            ratio = letterbox_ratio((h, w), self.config.test_size)
            rows = dets[i][valid[i]]
            results.append(Detections(
                bboxes=[tuple((row[:4] / ratio).tolist()) for row in rows],
                scores=[float(row[4]) * float(row[5]) for row in rows],
                labels=[int(row[6]) for row in rows],
            ))
        return results
