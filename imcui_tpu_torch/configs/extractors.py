"""Extractor configs: this package's own copy of the registry in
``imcui_tpu/configs/extractors.py``, key for key (a test compares the two
dicts), so user configs resolve unchanged. Pure data; every entry names
a model this package has ported.
"""

confs = {
    "superpoint_aachen": {
        "output": "feats-superpoint-n4096-r1024",
        "model": {
            "name": "superpoint",
            "nms_radius": 3,
            "max_keypoints": 4096,
            "keypoint_threshold": 0.005,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1600,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
    },
    "superpoint_max": {
        "output": "feats-superpoint-n4096-rmax1600",
        "model": {
            "name": "superpoint",
            "nms_radius": 3,
            "max_keypoints": 4096,
            "keypoint_threshold": 0.005,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1600,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
    },
    "superpoint_inloc": {
        "output": "feats-superpoint-n4096-r1600",
        "model": {
            "name": "superpoint",
            "nms_radius": 4,
            "max_keypoints": 4096,
            "keypoint_threshold": 0.005,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1600,
        },
    },
    # TPU throughput operating point (ours): the BASELINE.json headline
    # config — 1024 keypoints at 1024 px for pair-batched serving.
    "superpoint_1024": {
        "output": "feats-superpoint-n1024-r1024",
        "model": {
            "name": "superpoint",
            "nms_radius": 4,
            "max_keypoints": 1024,
            "keypoint_threshold": 0.005,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
        },
    },
    "disk": {
        "output": "feats-disk",
        "model": {
            "name": "disk",
            "max_keypoints": 5000,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1600,
        },
    },
    "aliked-n16": {
        "output": "feats-aliked-n16",
        "model": {
            "name": "aliked",
            "model_name": "aliked-n16",
            "max_num_keypoints": -1,
            "detection_threshold": 0.2,
            "nms_radius": 2,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
        },
    },
    "alike": {
        "output": "feats-alike-n",
        "model": {
            "name": "alike",
            "model_name": "alike-n",
            "use_relu": True,
            "multiscale": False,
            "max_keypoints": 4096,
            "detection_threshold": 0.2,
            "sub_pixel": True,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
        },
    },
    "xfeat": {
        "output": "feats-xfeat-n5000-r1600",
        "model": {
            "name": "xfeat",
            "max_keypoints": 5000,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1600,
        },
    },
    "r2d2": {
        "output": "feats-r2d2-n5000-r1024",
        "model": {
            "name": "r2d2",
            "max_keypoints": 5000,
            "reliability_threshold": 0.7,
            "repetability_threshold": 0.7,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
    },
    "d2net-ss": {
        "output": "feats-d2net-ss",
        "model": {
            "name": "d2net",
            "multiscale": False,
            "max_keypoints": 4096,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1600,
        },
    },
    "dedode": {
        "output": "feats-dedode-n5000-r1600",
        "model": {
            "name": "dedode",
            "max_keypoints": 5000,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1600,
        },
    },
    "rord": {
        # RoRD is the D2-Net architecture trained for rotation robustness
        # (reference: imcui/hloc/extractors/rord.py:16) — a checkpoint
        # variant of our d2net module.
        "output": "feats-rord",
        "model": {
            "name": "d2net",
            "model_name": "rord.pth",
            "multiscale": False,
            "max_keypoints": 4096,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1600,
        },
    },
    "example": {
        "output": "feats-example",
        "model": {"name": "example", "max_keypoints": 512},
        "preprocessing": {"grayscale": True, "resize_max": 1024},
    },
    "sift": {
        "output": "feats-sift",
        "model": {
            "name": "sift",
            "rootsift": True,
            "max_keypoints": 5000,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1600,
        },
    },
    "dog": {
        "output": "feats-dog",
        "model": {"name": "dog", "descriptor": "rootsift",
                  "max_keypoints": 5000},
        "preprocessing": {"grayscale": True, "resize_max": 1600},
    },
    "dog-hardnet": {
        "output": "feats-dog-hardnet",
        "model": {"name": "dog", "descriptor": "hardnet",
                  "max_keypoints": 5000},
        "preprocessing": {"grayscale": True, "resize_max": 1600},
    },
    "dog-sosnet": {
        "output": "feats-dog-sosnet",
        "model": {"name": "dog", "descriptor": "sosnet",
                  "max_keypoints": 5000},
        "preprocessing": {"grayscale": True, "resize_max": 1600},
    },
    "lanet": {
        "output": "feats-lanet-n5000-r1600",
        "model": {
            "name": "lanet",
            "keypoint_threshold": 0.1,
            "max_keypoints": 5000,
        },
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "darkfeat": {
        "output": "feats-darkfeat-n5000-r1600",
        "model": {
            "name": "darkfeat",
            "max_keypoints": 5000,
            "detection_threshold": 0.5,
            "sub_pixel": False,
        },
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "sfd2": {
        "output": "feats-sfd2-n4096-r1600",
        "model": {"name": "sfd2", "max_keypoints": 4096},
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "liftfeat": {
        "output": "feats-liftfeat-n5000-r1600",
        "model": {"name": "liftfeat", "max_keypoints": 5000},
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "rdd": {
        "output": "feats-rdd-n5000-r1600",
        "model": {"name": "rdd", "max_keypoints": 5000},
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "ripe": {
        "output": "feats-ripe-n2048-r1600",
        "model": {"name": "ripe", "max_keypoints": 2048},
        "preprocessing": {"grayscale": False, "resize_max": 1600},
    },
    "rekd": {
        "output": "feats-rekd-n1024",
        "model": {"name": "rekd", "keypoint_threshold": 0.1,
                  "max_keypoints": 1024},
        "preprocessing": {"grayscale": True, "resize_max": 1024},
    },
    "raco": {
        "output": "feats-raco",
        "model": {
            "name": "raco",
            "model_name": "raco",
            "max_num_keypoints": 1024,
        },
        "preprocessing": {"grayscale": False, "resize_max": 1024},
    },
    # global descriptors for retrieval (reference:
    # configs/extractors.py:366-392)
    "netvlad": {
        "output": "global-feats-netvlad",
        "model": {"name": "netvlad"},
        "preprocessing": {"resize_max": 1024},
    },
    "cosplace": {
        "output": "global-feats-cosplace",
        "model": {"name": "cosplace"},
        "preprocessing": {"resize_max": 1024},
    },
    "eigenplaces": {
        "output": "global-feats-eigenplaces",
        "model": {"name": "eigenplaces"},
        "preprocessing": {"resize_max": 1024},
    },
    "dir": {
        "output": "global-feats-dir",
        "model": {"name": "dir"},
        "preprocessing": {"resize_max": 1024},
    },
    "openibl": {
        "output": "global-feats-openibl",
        "model": {"name": "openibl"},
        "preprocessing": {"resize_max": 1024},
    },
    "fire": {
        "output": "global-feats-fire",
        "model": {"name": "fire"},
        "preprocessing": {"resize_max": 1024},
    },
    "fire_local": {
        "output": "feats-fire-local",
        "model": {"name": "fire_local", "features_num": 1000},
        "preprocessing": {"resize_max": 1024},
    },
}

# reference config/app.yaml names the DoG+patch-CNN features plainly
confs["hardnet"] = confs["dog-hardnet"]
confs["sosnet"] = confs["dog-sosnet"]
