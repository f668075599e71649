from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer

__all__ = ["DistributedALS", "GAT", "GATLayer"]
