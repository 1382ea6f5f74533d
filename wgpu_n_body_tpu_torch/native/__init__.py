"""Native (C++) host components. See native/build.py for the loader."""

from wgpu_n_body_tpu_torch.native.build import (
    HostOctree,
    build_host_tree,
    native_available,
)

__all__ = ["HostOctree", "build_host_tree", "native_available"]
