from otamg_torch.amg.graph import (  # noqa: F401
    component_stats,
    connected_components_bipartite,
    mis_dense,
    strength_dense,
)
from otamg_torch.amg.hierarchy import (  # noqa: F401
    AggCSRLevel,
    BipartiteLevel,
    CSRLevel,
    DenseLevel,
    amg_solve,
    amg_solve_matrix,
    make_cycle,
    setup_hierarchy,
    setup_hierarchy_generic,
    setup_hierarchy_sparse,
)
