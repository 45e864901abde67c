"""Evaluation: the COCO and VOC evaluators and their host-side metrics."""

from yolox_tpu_torch.evaluators.coco_evaluator import CocoEvaluator
from yolox_tpu_torch.evaluators.voc_eval import voc_eval
from yolox_tpu_torch.evaluators.voc_evaluator import VocEvaluator

__all__ = ["CocoEvaluator", "voc_eval", "VocEvaluator"]
