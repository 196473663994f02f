from aloam_tpu_torch.frontend.registration import register_scan_b  # noqa: F401
from aloam_tpu_torch.frontend.features import extract_features_b  # noqa: F401
from aloam_tpu_torch.frontend.voxel import voxel_downsample_rings  # noqa: F401
