"""The port's logger, `logging.getLogger("yolox_tpu_torch")`.

The JAX package's `setup_logger` (a file handler on rank 0 and the
stdout/stderr redirection) comes with the trainer (ROADMAP M7); until then
the caller configures logging as it likes.
"""

import logging

logger = logging.getLogger("yolox_tpu_torch")
