from repro_torch.serving.executor import SingleDeviceExecutor
from repro_torch.serving.factory import EXECUTOR_KINDS, make_executor

__all__ = ["EXECUTOR_KINDS", "SingleDeviceExecutor", "make_executor"]
