"""The paper's own architecture: the Table II DVS-Gesture SCNN executed by
SNE, plus the pipeline constants (300 ms windows, DVS128 input) and the
mirror CUTIE ternary CNN for the frame wing."""
from repro_torch.core.lif import LIFParams
from repro_torch.core.snn import SNNConfig
from repro_torch.core.tcn import TCNConfig

# Full paper network (Table II): 128x128x2 -> pool4 -> conv16 -> pool2 ->
# conv32 -> pool2 -> fc512 -> fc11.
CONFIG = SNNConfig(
    height=128, width=128, in_channels=2, pool0=4,
    conv1_features=16, conv2_features=32, hidden=512, num_classes=11,
    time_bins=16, lif=LIFParams(alpha=0.875, v_th=0.5,
                                surrogate_width=2.0),
)

# Reduced smoke variant (same family, 32x32 sensor crop).
SMOKE = SNNConfig(
    height=32, width=32, in_channels=2, pool0=4,
    conv1_features=4, conv2_features=8, hidden=32, num_classes=11,
    time_bins=8,
)

# Frame wing: the CUTIE ternary CNN mirroring the SCNN layer-for-layer
# (frames in, same pooling/feature schedule, fp classifier).
TCN_CONFIG = TCNConfig(
    height=128, width=128, in_channels=1, pool0=4,
    conv1_features=16, conv2_features=32, hidden=512, num_classes=11,
)

TCN_SMOKE = TCNConfig(
    height=32, width=32, in_channels=1, pool0=4,
    conv1_features=4, conv2_features=8, hidden=32, num_classes=11,
)

WINDOW_MS = 300.0
