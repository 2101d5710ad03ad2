"""Case apps (port of `cfdnn_tpu/apps/`): channel, cylinder, duct and
taylor_green_3d, run as `python -m cfdnn_tpu_torch.apps.<case> [--key
value ...]`, on the CUDA card unless `--platform cpu` is given."""

__all__ = ["channel", "cylinder", "duct", "taylor_green_3d"]
