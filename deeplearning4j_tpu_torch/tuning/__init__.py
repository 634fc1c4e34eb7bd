"""Fused-loop tuning: the port of ``deeplearning4j_tpu/tuning/``."""
