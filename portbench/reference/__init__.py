"""The plain reference the benchmark judges the program by: the models'
residual and scales (``residual.py``) and the Δt controller's rules
(``controller.py``), in plain PyTorch and Python, importing nothing of the
program or of the JAX package."""
