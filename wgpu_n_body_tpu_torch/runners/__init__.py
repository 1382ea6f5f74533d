"""Drivers: headless step loop, trajectory IO, offline + online renderers."""

from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.online import OnlineViewer
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader, TrajectoryWriter

__all__ = ["OfflineHeadless", "OnlineViewer", "TrajectoryWriter", "TrajectoryReader"]
