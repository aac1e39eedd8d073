# The paper's multilinear kernel (§III-A), the algebraic Awerbuch-Shiloach
# MSF algorithm (§III-B), the shortcutting optimizations (§IV-B) and the
# AS/SV connectivity baseline (§II-D).
from repro_torch.core.msf import MSFResult, flat_msf, run_flat, starcheck
from repro_torch.core.connectivity import CCResult, connected_components
from repro_torch.core.multilinear import (
    min_outgoing_coo,
    min_outgoing_coo_packed,
    min_outgoing_dense,
    multilinear_coo,
    project_to_roots,
)
from repro_torch.core.semiring import (
    EdgeMin,
    axis_argmin,
    pack32,
    segment_argmin,
    unpack32,
)
from repro_torch.core import shortcut
