from repro_torch.graphs.structures import (
    Graph,
    canonical_edges,
    dedupe_canonical,
    edge_keys,
    from_arrays,
    from_edges,
    from_reference,
    graph_from_canonical,
    resolve_device,
    to_csr,
)
from repro_torch.graphs.generators import (
    assign_distinct_weights,
    components_graph,
    grid_road_graph,
    random_graph,
    rmat_graph,
)
