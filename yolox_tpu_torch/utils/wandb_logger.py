"""Weights & Biases experiment tracking, the port's copy of the JAX
package's `yolox_tpu/utils/wandb_logger.py`, imported only when the
trainer's `args.logger` is "wandb".

A re-design of the reference's `yolox/utils/logger.py:116-439`
(`WandbLogger`): run init from config, scalar metrics, validation-image
prediction tables, and checkpoint artifacts. The reference implementation
crashes when selected (it reads `args.opts`, which the fork's train CLI
never defines — see reference `yolox/utils/logger.py:432` vs
`yolox/cli/train.py:19-92`); this one works.

Configuration is env-var driven, mirroring the MLflow logger:

  WANDB_PROJECT            project name       (default "yolox_tpu")
  WANDB_NAME               run display name   (default: config name)
  WANDB_ENTITY / WANDB_ID  forwarded to wandb.init when set
  YOLOX_WANDB_LOG_CHECKPOINTS=true   upload checkpoints as artifacts
  YOLOX_WANDB_NUM_EVAL_IMAGES        rows in the prediction table (def 100)

Degrades to a no-op with a warning when the `wandb` package is not
installed (it is not part of the supported environment; the default
tracker is tensorboard).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from yolox_tpu_torch.utils.logger import logger

_TRUTHY = ("true", "1", "yes")


class WandbLogger:
    def __init__(self, config=None, args=None):
        try:
            import wandb

            self._wandb = wandb
        except ImportError:
            self._wandb = None
            logger.warning(
                "wandb is not installed; WandbLogger is a no-op. "
                "`pip install wandb` to enable it.")
        self._run = None
        self._config = config
        self._args = args
        self.log_checkpoints = os.getenv(
            "YOLOX_WANDB_LOG_CHECKPOINTS", "").lower() in _TRUTHY
        self.num_eval_images = int(
            os.getenv("YOLOX_WANDB_NUM_EVAL_IMAGES", "100"))

    @property
    def enabled(self) -> bool:
        return self._wandb is not None

    def setup(self, args=None, exp=None):
        """Start the run and record the full config as wandb config."""
        if not self.enabled:
            return
        self._config = exp if exp is not None else self._config
        self._args = args if args is not None else self._args
        init_kwargs = {
            "project": os.getenv("WANDB_PROJECT", "yolox_tpu"),
            "name": os.getenv("WANDB_NAME")
            or getattr(self._config, "name", None),
        }
        for env, key in (("WANDB_ENTITY", "entity"), ("WANDB_ID", "id")):
            if os.getenv(env):
                init_kwargs[key] = os.getenv(env)
        self._run = self._wandb.init(**init_kwargs)
        cfg = {}
        if self._config is not None:
            cfg.update({
                k: v for k, v in vars(self._config).items()
                if isinstance(v, (int, float, str, bool, tuple, list))
            })
        if self._args is not None:
            cfg.update({f"args/{k}": v for k, v in vars(self._args).items()
                        if isinstance(v, (int, float, str, bool))})
        self._run.config.update(cfg, allow_val_change=True)

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._run is None:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if step is not None:
            self._run.log(clean, step=int(step))
        else:
            self._run.log(clean)

    def log_images(self, predictions, class_names=None):
        """Log a table of per-image predictions (reference
        `logger.py:319-388` analog). `predictions` maps image id/path ->
        {"bboxes": [xyxy], "scores": [...], "categories": [...]}.
        """
        if self._run is None or not predictions:
            return
        table = self._wandb.Table(
            columns=["image_id", "num_boxes", "mean_score", "categories"])
        for i, (img_id, pred) in enumerate(predictions.items()):
            if i >= self.num_eval_images:
                break
            scores = [float(s) for s in pred.get("scores", [])]
            cats = pred.get("categories", [])
            if class_names is not None:
                cats = [class_names[int(c)] if int(c) < len(class_names)
                        else int(c) for c in cats]
            mean_score = sum(scores) / len(scores) if scores else 0.0
            table.add_data(str(img_id), len(scores), mean_score,
                           ", ".join(str(c) for c in cats[:20]))
        self._run.log({"val/predictions": table})

    def save_checkpoint(self, save_dir: str, model_name: str, is_best: bool,
                        metadata: Optional[dict] = None):
        """Upload a checkpoint file as a wandb artifact (reference
        `logger.py:390-423` analog), alias "best" when applicable."""
        if self._run is None or not self.log_checkpoints:
            return
        # checkpoint.save_checkpoint writes '<model_name>_ckpt.pth'
        path = os.path.join(save_dir, f"{model_name}_ckpt.pth")
        if not os.path.exists(path):
            return
        artifact = self._wandb.Artifact(
            name=f"run_{self._run.id}_model", type="model",
            metadata=metadata or {})
        artifact.add_file(path, name="model_ckpt.pth")
        aliases = ["latest", "best"] if is_best else ["latest"]
        self._run.log_artifact(artifact, aliases=aliases)

    def finish(self):
        if self._run is not None:
            self._run.finish()
            self._run = None
