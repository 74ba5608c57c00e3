"""W&B logging defaults (the port's copy of ``climb_tpu/configs/wandb_config.py``;
reference ``src/configs/wandb_config.py``)."""

wandb_config = {
    "entity": "",        # your W&B username
    "api_key": "",       # your W&B API key
    "project_name": "climb-tpu",
    "log_freq": 100,
}
