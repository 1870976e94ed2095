from genpc_tpu_torch.ops.chamfer import chamfer_nn, chamfer_distances  # noqa: F401
from genpc_tpu_torch.ops.fps import farthest_point_sample, fps_indices  # noqa: F401
from genpc_tpu_torch.ops.emd import emd_auction  # noqa: F401
from genpc_tpu_torch.ops.knn import knn  # noqa: F401
from genpc_tpu_torch.ops.outliers import statistical_outlier_mask  # noqa: F401
