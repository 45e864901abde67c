"""MLflow experiment tracking, the port's copy of the JAX package's
`yolox_tpu/utils/mlflow_logger.py` (the reference's
`yolox/utils/mlflow_logger.py`, env-var driven). Imported only when the
trainer's `args.logger` is "mlflow".

Supported environment variables (same names/defaults as the reference):

  MLFLOW_TRACKING_URI                   tracking server / store URI
  MLFLOW_EXPERIMENT_NAME                experiment (also accepts
                                        YOLOX_MLFLOW_EXPERIMENT_NAME)
  MLFLOW_TAGS                           JSON dict of run tags
  MLFLOW_NESTED_RUN                     start as a nested run
  MLFLOW_RUN_ID                         attach to an existing run (resume)
  YOLOX_MLFLOW_RUN_NAME                 run display name
  YOLOX_MLFLOW_FLATTEN_PARAMS           flatten nested params with
                                        dotted keys
  YOLOX_MLFLOW_LOG_MODEL_ARTIFACTS      upload checkpoints as artifacts
  YOLOX_MLFLOW_LOG_MODEL_PER_n_EPOCHS   artifact cadence (default 30)
  YOLOX_MLFLOW_LOG_Nth_EPOCH_MODELS     also upload per-epoch history
                                        checkpoints at that cadence

Degrades to a warning when the mlflow package is not installed (it is not
part of the supported environment; the default tracker is tensorboard).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from yolox_tpu_torch.utils.logger import logger

# mlflow rejects oversized values / too many params per call; same bounds
# the reference inherits from its integration (mlflow_logger.py:44-47)
MAX_PARAM_VAL_LENGTH = 500
MAX_PARAMS_TAGS_PER_BATCH = 100


def _env_bool(name: str, default: str = "False") -> bool:
    return os.getenv(name, default).upper() in {"TRUE", "1", "YES"}


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


class MlflowLogger:
    def __init__(self):
        try:
            import mlflow  # noqa: F401

            self._mlflow = mlflow
        except ImportError:
            self._mlflow = None
            logger.warning(
                "mlflow is not installed; MlflowLogger is a no-op. "
                "`pip install mlflow` to enable it.")
        self._run = None
        self.tracking_uri = os.getenv("MLFLOW_TRACKING_URI")
        self.experiment_name = (
            os.getenv("MLFLOW_EXPERIMENT_NAME")
            or os.getenv("YOLOX_MLFLOW_EXPERIMENT_NAME")
            or "yolox_tpu")
        self.run_name = os.getenv("YOLOX_MLFLOW_RUN_NAME")
        self.run_id = os.getenv("MLFLOW_RUN_ID")
        self.nested_run = _env_bool("MLFLOW_NESTED_RUN")
        self.flatten_params = _env_bool("YOLOX_MLFLOW_FLATTEN_PARAMS")
        self.log_artifacts = _env_bool("YOLOX_MLFLOW_LOG_MODEL_ARTIFACTS")
        self.log_per_n_epochs = int(
            os.getenv("YOLOX_MLFLOW_LOG_MODEL_PER_n_EPOCHS", "30"))
        self.log_nth_epoch_models = _env_bool(
            "YOLOX_MLFLOW_LOG_Nth_EPOCH_MODELS")

    @property
    def enabled(self) -> bool:
        return self._mlflow is not None

    # ------------------------------------------------------------- setup

    def setup(self, args=None, exp=None):
        if not self.enabled:
            return
        if self.tracking_uri:
            self._mlflow.set_tracking_uri(self.tracking_uri)
        self._mlflow.set_experiment(self.experiment_name)
        run_name = self.run_name or getattr(exp, "name", None)
        start_kwargs: Dict[str, Any] = {"run_name": run_name}
        if self.run_id:
            start_kwargs["run_id"] = self.run_id
        if self.nested_run:
            start_kwargs["nested"] = True
        self._run = self._mlflow.start_run(**start_kwargs)

        tags = os.getenv("MLFLOW_TAGS")
        if tags and hasattr(self._mlflow, "set_tags"):
            self._mlflow.set_tags(json.loads(tags))

        params: Dict[str, Any] = {}
        if exp is not None:
            params.update(vars(exp))
        if args is not None:
            params.update({f"args.{k}": v for k, v in vars(args).items()})
        self._log_params(params)

    def _log_params(self, params: Dict[str, Any]):
        if self.flatten_params:
            params = _flatten(
                {k: v for k, v in params.items()})
        clean: Dict[str, str] = {}
        for k, v in params.items():
            if isinstance(v, dict) and not self.flatten_params:
                continue
            s = str(v)
            if len(s) > MAX_PARAM_VAL_LENGTH:
                logger.warning(
                    f"mlflow: truncating oversized param {k!r} "
                    f"({len(s)} chars)")
                s = s[:MAX_PARAM_VAL_LENGTH]
            clean[str(k)] = s
        items = list(clean.items())
        for i in range(0, len(items), MAX_PARAMS_TAGS_PER_BATCH):
            self._mlflow.log_params(
                dict(items[i:i + MAX_PARAMS_TAGS_PER_BATCH]))

    # ------------------------------------------------------------ logging

    def on_log(self, args, exp, epoch: int, logs: Dict[str, Any]):
        if not self.enabled or self._run is None:
            return
        metrics = {}
        for k, v in logs.items():
            try:
                metrics[k.replace("/", "_")] = float(v)
            except (TypeError, ValueError):
                continue
        if metrics:
            self._mlflow.log_metrics(metrics, step=epoch)

    def save_checkpoints(self, args, exp, file_name, epoch, metadata,
                         update_best_ckpt):
        """Upload checkpoints per the reference cadence
        (mlflow_logger.py:114-121): 'latest' every n epochs, 'best' when it
        improves, per-epoch history files when Nth-epoch logging is on."""
        if not self.enabled or self._run is None or not self.log_artifacts:
            return

        def _log(name):
            path = os.path.join(file_name, name)
            if os.path.exists(path):
                self._mlflow.log_artifact(path)

        on_cadence = epoch % max(self.log_per_n_epochs, 1) == 0
        if on_cadence:
            _log("latest_ckpt.pth")
            if self.log_nth_epoch_models:
                _log(f"epoch_{epoch}_ckpt.pth")
        if update_best_ckpt:
            _log("best_ckpt.pth")

    def on_train_end(self, args, file_name=None,
                     metadata: Optional[dict] = None):
        if not self.enabled or self._run is None:
            return
        if metadata:
            self._log_params({f"final_{k}": v for k, v in metadata.items()})
        if self.log_artifacts and file_name:
            for name in ("latest_ckpt.pth", "best_ckpt.pth"):
                path = os.path.join(file_name, name)
                if os.path.exists(path):
                    self._mlflow.log_artifact(path)
        self._mlflow.end_run()
