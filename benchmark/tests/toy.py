"""Toy sizes of the cells for the CPU: the same code paths at a size a test run holds.

The toy cells carry limits of their own, set as the cells' were, from the
program's and the control's readings at the toy size on six seeds, on the CPU:
at 160x120 and 6 frames the largest pose gap over a fragment swings with one
frame's association flips (up to 3.2e-3 m for the program, as large as the
control's), so the toy compares the median gaps, which read at most 8.3e-6 m
and 4.4e-6 rad for the program and at least 4.2e-4 m and 1.3e-4 rad for the
control (TF32 products); the cloud fused at the program's poses reads a median
gap of 0 for the program on four seeds and at least 2.2e-5 m for the control
(TF32 products, the TSDF stored in bfloat16), whose median pose gaps read at
least 3.1e-4 m and 2.3e-4 rad there. Registration (four fragments of the toy
orbit, three pairs) reads 0 for the program on six seeds; the control reads at
least 1.0e-3 m, 2.4e-3 rad, 1.3e-3 in fitness and 9.3e-4 in information on
four of them and 0 on two, where TF32's rounding changes no decision of three
pairs: the toy's control test uses ``SEED``, on which it reads 5.0e-3 m. At
the cell's own size the control is read on the card
(``test_benchmark_control``).
"""

ODOMETRY = {
    "config": {
        "camera": {"fx": 200.0, "fy": 200.0, "cx": 79.5, "cy": 59.5, "width": 160, "height": 120},
        "frames_per_fragment": 6,
        "fragment": {"volume_shape": [64, 64, 64], "voxel_size": 0.05, "volume_min_z": 0.3, "cloud_capacity": 16384,
                     "max_weight": 64.0, "depth_min": 0.1, "depth_max": 6.0},
        "odometry": {"levels": 3, "iterations": [4, 5, 10], "dist_threshold": 0.1, "normal_threshold": 0.6,
                     "depth_min": 0.1, "depth_max": 6.0, "raycast_steps": 96, "raycast_scale": 1, "damping": 1e-6,
                     "min_support": 50.0, "max_step": 0.5, "velocity_gain": 1.0, "prior_beta": 0.05,
                     "healthy_obs_ratio": 0.005, "healthy_fitness": 0.5},
    },
    "traffic": {"frames_per_orbit": 600},
    "limits": {"pose_gap_median_m": 1e-4, "pose_gap_median_rad": 3e-5, "cloud_gap_median_m": 2e-6},
}

REGISTER = {
    "traffic": {"fragments": 4, "stride": 2, "frames_per_orbit": 600},
    "config": {
        "camera": ODOMETRY["config"]["camera"],
        "frames_per_fragment": 6,
        "fragment": ODOMETRY["config"]["fragment"],
        "registration": {
            "voxel_size": 0.1, "icp_voxel_size": 0.05, "coarse_capacity": 1024, "fine_capacity": 2048,
            "normal_radius_factor": 2.0, "fpfh_radius_factor": 5.0, "inlier_threshold": 0.075, "edge_similarity": 0.9,
            "num_hypotheses": 512, "icp_iterations": 30, "icp_src_stride": 2, "icp_coarse_iterations": 12,
            "icp_coarse_stride": 4, "min_inliers": 12, "min_fitness": 0.25},
        "registration_batch": 3,
    },
    "limits": {"transform_gap_m": 2e-4, "transform_gap_rad": 2e-4, "fitness_gap": 2e-4, "information_gap": 3e-4},
}

CELLS = {"odometry.livingroom_full_640": ODOMETRY, "register.livingroom_full_640": REGISTER}
SEED = 2**31 + 987654321  # larger than 32 signed bits hold: seeds of any size must work
