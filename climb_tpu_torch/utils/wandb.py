"""The W&B logger (the port's copy of ``climb_tpu/utils/wandb.py``; reference
``src/utils/wandb.py``).

``log()`` does nothing until ``initialize()`` is called; ``get_log_freq()``
is 100 until then. The ``wandb`` package is imported only by ``initialize``
and is optional: without it the logger keeps an in-memory history only
(``_history``, which is kept either way).
"""

import logging
import os

logger = logging.getLogger(__name__)


class WandBLogger:
    def __init__(self):
        self.is_initialized = False
        self.log_freq = 100
        self._history = []

    def initialize(self, wandb_config: dict, experiment_name: str):
        try:
            import wandb
        except ImportError:
            logger.warning("wandb not installed; logging to in-memory history only")
            self.is_initialized = True
            self.log_freq = wandb_config.get("log_freq", 100)
            self._wandb = None
            return
        os.environ["WANDB_API_KEY"] = wandb_config.get("api_key", "")
        wandb.init(
            entity=wandb_config.get("entity"),
            project=wandb_config.get("project_name"),
            name=experiment_name,
        )
        self._wandb = wandb
        self.is_initialized = True
        self.log_freq = wandb_config.get("log_freq", 100)

    def log(self, log_dict: dict):
        if not self.is_initialized:
            return
        self._history.append(dict(log_dict))
        if getattr(self, "_wandb", None) is not None:
            self._wandb.log(log_dict)

    def get_log_freq(self) -> int:
        return self.log_freq if self.is_initialized else 100


wandb_logger = WandBLogger()
