# The paper's multilinear kernel (§III-A), the algebraic Awerbuch-Shiloach
# MSF algorithm (§III-B), the shortcutting optimizations (§IV-B), the
# distributed Fig-2 driver on a torch.distributed rank grid (§IV-A) and the
# AS/SV connectivity baseline (§II-D).
from repro_torch.core.msf import MSFResult, flat_msf, run_flat, starcheck
from repro_torch.core.msf_dist import DistMSFResult, build_dist_driver
from repro_torch.core.connectivity import CCResult, connected_components
from repro_torch.core.multilinear import (
    gather_row_col_vectors,
    min_outgoing_2d,
    min_outgoing_2d_packed,
    min_outgoing_coo,
    min_outgoing_coo_packed,
    min_outgoing_dense,
    multilinear_coo,
    project_to_roots,
    spmm_sum_2d,
)
from repro_torch.core.semiring import (
    EdgeMin,
    allreduce_argmin,
    axis_argmin,
    pack32,
    segment_argmin,
    unpack32,
)
from repro_torch.core import shortcut
