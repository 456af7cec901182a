"""Matcher configs: this package's own copy of the registry in
``imcui_tpu/configs/matchers.py``, key for key (a test compares the two
dicts), so user configs resolve unchanged. Pure data; every entry names
a model this package has ported.
"""

confs = {
    # ------------------------------------------------------------------
    # sparse matchers
    # ------------------------------------------------------------------
    "superglue": {
        "output": "matches-superglue",
        "model": {
            "name": "superglue",
            "weights": "outdoor",
            "sinkhorn_iterations": 50,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "superglue-fast": {
        "output": "matches-superglue-it5",
        "model": {
            "name": "superglue",
            "weights": "outdoor",
            "sinkhorn_iterations": 5,
            "match_threshold": 0.2,
        },
    },
    "superpoint-lightglue": {
        "output": "matches-lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "superpoint",
            "model_name": "superpoint_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "disk-lightglue": {
        "output": "matches-disk-lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "disk",
            "model_name": "disk_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "aliked-lightglue": {
        "output": "matches-aliked-lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "aliked",
            "model_name": "aliked_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "sift-lightglue": {
        "output": "matches-sift-lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "sift",
            "add_scale_ori": True,
            "model_name": "sift_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "sgmnet": {
        "output": "matches-sgmnet",
        "model": {
            "name": "sgmnet",
            "seed_top_k": 128,
            "seed_radius_coe": 0.01,
            "net_channels": 128,
            "layer_num": 4,
            "sinkhorn_iterations": 30,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "NN-superpoint": {
        "output": "matches-NN-mutual-dist.7",
        "model": {
            "name": "nearest_neighbor",
            "do_mutual_check": True,
            "distance_threshold": 0.7,
        },
    },
    "NN-ratio": {
        "output": "matches-NN-mutual-ratio.8",
        "model": {
            "name": "nearest_neighbor",
            "do_mutual_check": True,
            "ratio_threshold": 0.8,
        },
    },
    "NN-mutual": {
        "output": "matches-NN-mutual",
        "model": {
            "name": "nearest_neighbor",
            "do_mutual_check": True,
        },
    },
    "Dual-Softmax": {
        "output": "matches-Dual-Softmax",
        "model": {
            "name": "dual_softmax",
            "match_threshold": 0.2,
            "inv_temperature": 20,
        },
    },
    "adalam": {
        "output": "matches-adalam",
        "model": {
            "name": "adalam",
        },
    },
    # ------------------------------------------------------------------
    # dense (standalone) matchers
    # ------------------------------------------------------------------
    "loftr": {
        "output": "matches-loftr",
        "model": {
            "name": "loftr",
            "weights": "outdoor",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "eloftr": {
        "output": "matches-eloftr",
        "model": {
            "name": "eloftr",
            "weights": "weights/eloftr_outdoor.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 32,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "roma": {
        "output": "matches-roma",
        "model": {
            "name": "roma",
            "model_name": "roma_outdoor.pth",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "dkm": {
        "output": "matches-dkm",
        "model": {
            "name": "dkm",
            "model_name": "DKMv3_outdoor.pth",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 80,
            "height": 60,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "duster": {
        "output": "matches-duster",
        "model": {
            "name": "duster",
            "weights": "duster_vit_large",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 512,
            "dfactor": 16,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "mast3r": {
        "output": "matches-mast3r",
        "model": {
            "name": "mast3r",
            "weights": "mast3r_vit_large",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 512,
            "dfactor": 16,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "example": {
        "output": "matches-example",
        "model": {"name": "example", "match_threshold": 0.2},
        "preprocessing": {"grayscale": True, "resize_max": 1024,
                          "dfactor": 8},
        "max_error": 1, "cell_size": 1,
    },
    "xfeat-lightglue": {
        "output": "matches-xfeat-lightglue",
        "model": {
            "name": "xfeat_lightglue",
            "max_keypoints": 4096,
            "match_threshold": 0.1,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": False,
            "resize_max": 1024,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    # ------------------------------------------------------------------
    # checkpoint variants of implemented architectures (the reference
    # treats these the same way: one wrapper, different weights —
    # e.g. minima_lightglue/gim_dkm/dad_roma in configs/matchers.py)
    # ------------------------------------------------------------------
    "minima_lightglue": {
        "output": "matches-minima_lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "superpoint",
            "model_name": "minima_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "minima_loftr": {
        "output": "matches-minima_loftr",
        "model": {
            "name": "loftr",
            "weights": "minima_loftr.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "minima_roma": {
        "output": "matches-minima_roma",
        "model": {
            "name": "roma",
            "model_name": "minima_roma.pth",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "gim(dkm)": {
        "output": "matches-gim",
        "model": {
            "name": "dkm",
            "model_name": "gim_dkm_100h.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "lisrd": {
        "output": "matches-lisrd",
        "model": {
            "name": "lisrd",
            "model_name": "lisrd_aachen",
            "max_keypoints": 2048,
            "detector": "superpoint",
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "gluestick": {
        "output": "matches-gluestick",
        "model": {
            "name": "gluestick",
            "max_keypoints": 1000,
            "max_lines": 300,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "xfeat_dense": {
        "output": "matches-xfeat_dense",
        "model": {
            "name": "xfeat_dense",
            "max_keypoints": 8000,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": False,
            "resize_max": 1024,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    # ------------------------------------------------------------------
    # round-1 closing batch (reference: configs/matchers.py — same names)
    # ------------------------------------------------------------------
    "aspanformer": {
        "output": "matches-aspanformer",
        "model": {
            "name": "aspanformer",
            "weights": "outdoor",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1024,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
    },
    "matchformer": {
        "output": "matches-matchformer",
        "model": {
            "name": "matchformer",
            "max_keypoints": 2048,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1024,
            "width": 640,
            "height": 480,
            "dfactor": 32,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "topicfm": {
        "output": "matches-topicfm",
        "model": {
            "name": "topicfm",
            "weights": "outdoor",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
        },
    },
    "xoftr": {
        "output": "matches-xoftr",
        "model": {
            "name": "xoftr",
            "weights": "weights_xoftr_640.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.3,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "minima_xoftr": {
        # checkpoint variant on the xoftr architecture
        "output": "matches-minima_xoftr",
        "model": {
            "name": "xoftr",
            "weights": "minima_xoftr.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.3,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "se2loftr": {
        "output": "matches-se2loftr",
        "model": {
            "name": "se2loftr",
            "max_keypoints": 2048,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 32,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "minima_eloftr": {
        # checkpoint variant on the eloftr architecture
        "output": "matches-minima_eloftr",
        "model": {
            "name": "eloftr",
            "model_name": "minima_eloftr.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 32,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "loftr_aachen": {
        "output": "matches-loftr_aachen",
        "model": {
            "name": "loftr",
            "weights": "outdoor",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {"grayscale": True, "resize_max": 1024,
                          "dfactor": 8},
        "max_error": 2,
        "cell_size": 8,
    },
    "loftr_superpoint": {
        "output": "matches-loftr_aachen",
        "model": {
            "name": "loftr",
            "weights": "outdoor",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 4,
        "cell_size": 4,
    },
    "superpoint-sphereglue": {
        "output": "matches-sphereglue",
        "model": {
            "name": "sphereglue",
            "match_threshold": 0.2,
            "sinkhorn_iterations": 20,
            "max_kpts": 20000,
            "knn": 20,
            "descriptor_dim": 256,
            "output_dim": 512,
            "model_name": "sphereglue_superpoint.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "sift-sphereglue": {
        "output": "matches-sift-sphereglue",
        "model": {
            "name": "sphereglue",
            "match_threshold": 0.2,
            "sinkhorn_iterations": 20,
            "max_kpts": 20000,
            "knn": 20,
            "descriptor_dim": 128,
            "output_dim": 256,
            "model_name": "sphereglue_sift.pth",
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
        },
    },
    "raco-lightglue": {
        "output": "matches-raco-lightglue",
        "model": {
            "name": "lightglue",
            "match_threshold": 0.2,
            "width_confidence": 0.99,
            "depth_confidence": 0.95,
            "features": "raco-aliked",
            "model_name": "raco_aliked_lightglue.pth",
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
            "dfactor": 32,
            "force_resize": False,
        },
    },
    "imp": {
        "output": "matches-imp",
        "model": {
            "name": "imp",
            "match_threshold": 0.2,
        },
    },
    "omniglue": {
        "output": "matches-omniglue",
        "model": {
            "name": "omniglue",
            "match_threshold": 0.2,
            "max_keypoints": 2000,
            "features": "null",
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
            "dfactor": 8,
            "force_resize": False,
            "width": 640,
            "height": 480,
        },
    },
    "cotr": {
        "output": "matches-cotr",
        "model": {
            "name": "cotr",
            "weights": "out/default",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "resize_max": 1024,
            "dfactor": 8,
            "width": 640,
            "height": 480,
            "force_resize": True,
        },
        "max_error": 1,
        "cell_size": 1,
    },
    "sold2": {
        "output": "matches-sold2",
        "model": {
            "name": "sold2",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": True,
            "force_resize": True,
            "resize_max": 1024,
            "width": 640,
            "height": 480,
            "dfactor": 8,
        },
    },
    "jamma": {
        "output": "matches-jamma",
        "model": {
            "name": "jamma",
            "weights": "jamma_weight.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.3,
        },
        "preprocessing": {
            "grayscale": True,
            "resize_max": 1024,
            "dfactor": 16,
            "width": 832,
            "height": 832,
            "force_resize": True,
        },
    },
    "mickey": {
        # not registered in the reference configs (the wrapper exists at
        # imcui/hloc/matchers/mickey.py but has no conf entry); added here
        # so the zoo can expose it
        "output": "matches-mickey",
        "model": {
            "name": "mickey",
            "model_name": "mickey.ckpt",
            "max_keypoints": 3000,
            "match_threshold": 0.0,
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
    "romav2": {
        "output": "matches-romav2",
        "model": {
            "name": "romav2",
            "max_keypoints": 2048,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 560,
            "height": 560,
            "dfactor": 8,
        },
    },
    "dad_roma": {
        "output": "matches-dad_roma",
        "model": {
            "name": "dad_roma",
            "weights": "outdoor",
            "model_name": "roma_outdoor.pth",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
    },
    "gim_roma": {
        # checkpoint variant on the roma architecture
        "output": "matches-gim_roma",
        "model": {
            "name": "roma",
            "model_name": "gim_roma_100h.ckpt",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
    },
    "rdd_dense": {
        "output": "matches-rdd_dense",
        "model": {
            "name": "rdd_dense",
            "model_name": "RDD-v2.pth",
            "max_keypoints": 2000,
            "match_threshold": 0.2,
        },
        "preprocessing": {
            "grayscale": False,
            "force_resize": True,
            "resize_max": 1024,
            "width": 320,
            "height": 240,
            "dfactor": 8,
        },
    },
    "loma-b": {
        "output": "matches-loma-b",
        "model": {
            "name": "loma",
            "model_name": "loma_b",
            "max_keypoints": 2048,
            "filter_threshold": 0.1,
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
    "loma-l": {
        "output": "matches-loma-l",
        "model": {
            "name": "loma",
            "model_name": "loma_l",
            "max_keypoints": 2048,
            "filter_threshold": 0.1,
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
    "loma-g": {
        "output": "matches-loma-g",
        "model": {
            "name": "loma",
            "model_name": "loma_g",
            "max_keypoints": 2048,
            "filter_threshold": 0.1,
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
    "loma-r": {
        "output": "matches-loma-r",
        "model": {
            "name": "loma",
            "model_name": "loma_r",
            "max_keypoints": 2048,
            "filter_threshold": 0.1,
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
    "lisrd-superpoint": {
        "output": "matches-lisrd-superpoint",
        "model": {
            "name": "lisrd",
            "model_name": "lisrd_aachen",
            "max_keypoints": 2048,
            "detector": "superpoint",
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
    "lisrd-aliked": {
        "output": "matches-lisrd-aliked",
        "model": {
            "name": "lisrd",
            "model_name": "lisrd_aachen",
            "max_keypoints": 2048,
            "detector": "aliked",
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
    "lisrd-sift": {
        "output": "matches-lisrd-sift",
        "model": {
            "name": "lisrd",
            "model_name": "lisrd_aachen",
            "max_keypoints": 2048,
            "detector": "sift",
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
}

# reference config/app.yaml refers to this conf with an underscore
confs["xfeat_lightglue"] = confs["xfeat-lightglue"]
