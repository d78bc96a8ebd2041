"""Multi-GPU: the device mesh (``mesh``) and width-sharded filtering
(``spatial``), the port of ``kfnet_tpu/parallel``."""
