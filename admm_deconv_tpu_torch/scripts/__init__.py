"""The port's command-line entry points, counterparts of the JAX package's
``scripts/`` under the same names: ``make_dataset``, ``demo_deconv`` and
``train``.  Run each as ``python -m admm_deconv_tpu_torch.scripts.<name>``."""
