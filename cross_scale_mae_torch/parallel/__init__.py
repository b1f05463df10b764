"""Data-parallel training over ``torch.distributed`` (counterpart of
``cross_scale_mae_tpu/parallel``): the process bootstrap (``dist``), the
data axis's reductions (``mesh``) and the collectives with gradients that
the global-batch losses use (``collectives``)."""
