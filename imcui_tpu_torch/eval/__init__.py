"""Offline accuracy harnesses: relative-pose AUC on calibrated pairs
(``megadepth.py``, ``synthpose.py``) and planted-homography recall
(``warp.py``). Counterpart of ``imcui_tpu/eval/``."""
