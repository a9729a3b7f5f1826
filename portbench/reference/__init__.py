"""The plain reference: float64 PyTorch, written from the model's
equations. It imports nothing of the program (neither ``cugp_tpu_torch``
nor the JAX package) and takes nothing the program made: it works the
covariance, its factor and every derived quantity out again from the
inputs the benchmark made.
"""
