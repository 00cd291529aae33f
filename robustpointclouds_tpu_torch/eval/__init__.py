"""Evaluation: the KITTI AP metric and the white-box gradient attacks."""
