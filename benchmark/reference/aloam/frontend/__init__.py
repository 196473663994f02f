from benchmark.reference.aloam.frontend.registration import (  # noqa: F401
    register_scan, register_scan_b)
from benchmark.reference.aloam.frontend.features import (  # noqa: F401
    extract_features, extract_features_b)
from benchmark.reference.aloam.frontend.voxel import (  # noqa: F401
    voxel_downsample_masked, voxel_downsample_masked_b,
    voxel_downsample_rings)
