"""Per-point window gather (counterpart of ``ptam_cg_tpu.ops.pallas_gather``).

The op lives beside its Hopper kernel in ``kernels/gather.py``.
"""

from ptam_cg_tpu_torch.kernels.gather import (  # noqa: F401
    gather_window_pair, gather_windows, gather_windows_plain)
