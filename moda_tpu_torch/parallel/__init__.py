"""Data-parallel training over processes (``dist.py``): the counterpart of
moda_tpu/parallel/mesh.py and of moda_tpu/cli/train_app.py's distributed
init."""
