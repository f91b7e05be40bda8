"""K-Radar 4D radar rasterization constants (dataset metadata); counterpart
of dpft_tpu/data/kradar/radar_info.py.

Values match the reference table (src/dprt/datasets/kradar/utils/
radar_info.py:3-113), which in turn encodes the K-Radar sensor's raster:
 - azimuth: 107 one-degree bins from +53 to -53 deg (descending order);
 - elevation: 37 one-degree bins from -18 to +18 deg;
 - range: 256 bins with spacing 118.5/256 m (0 .. ~118.04 m);
 - doppler: 64 bins, ~0.0604 m/s spacing, zero at index 32 (the exact
   published bin centers are kept verbatim because doppler features are
   produced by table lookup, processor.py:609-610).
"""

import numpy as np

azimuth_raster = np.arange(53, -54, -1, dtype=np.float64)  # +53 .. -53

elevation_raster = np.arange(-18, 19, dtype=np.float64)    # -18 .. +18

range_raster = np.arange(256, dtype=np.float64) * (118.5 / 256.0)

doppler_raster = np.array([
    -1.93259122, -1.87219774, -1.81180427, -1.75141079, -1.69101732,
    -1.63062384, -1.57023036, -1.50983689, -1.44944341, -1.38904994,
    -1.32865646, -1.26826299, -1.20786951, -1.14747604, -1.08708256,
    -1.02668908, -0.96629561, -0.90590213, -0.84550866, -0.78511518,
    -0.72472171, -0.66432823, -0.60393476, -0.54354128, -0.4831478,
    -0.42275433, -0.36236085, -0.30196738, -0.2415739, -0.18118043,
    -0.12078695, -0.06039348, 0.0, 0.06039348, 0.12078695,
    0.18118043, 0.2415739, 0.30196738, 0.36236085, 0.42275433,
    0.4831478, 0.54354128, 0.60393476, 0.66432823, 0.72472171,
    0.78511518, 0.84550866, 0.90590213, 0.96629561, 1.02668908,
    1.08708256, 1.14747604, 1.20786951, 1.26826299, 1.32865646,
    1.38904994, 1.44944341, 1.50983689, 1.57023036, 1.63062384,
    1.69101732, 1.75141079, 1.81180427, 1.87219774,
], dtype=np.float64)

# Radar response value range in dB used for input scaling.
max_power = 200
min_power = 100
