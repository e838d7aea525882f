"""The paper's conv workloads."""

from repro_torch.configs.paper_cnn import (BATCH, NETWORKS, TABLE2_LAYERS,
                                           dims, table2_dims)

__all__ = ["BATCH", "NETWORKS", "TABLE2_LAYERS", "dims", "table2_dims"]
