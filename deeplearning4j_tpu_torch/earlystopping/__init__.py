"""Early stopping: the port of ``deeplearning4j_tpu/earlystopping/``."""
