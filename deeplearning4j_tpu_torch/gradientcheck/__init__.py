"""Gradient checking: the port of ``deeplearning4j_tpu/gradientcheck/``."""
