"""The whole operation's share of the fp32 peak, in %, for every metric
of the ``mfu`` family (``mfu.fit``, ``mfu.iterative``, ``mfu.predict``):
the model FLOPs of the window's operations, which the cell's driver
counts from the shapes (frozen.dense_fit_step_flops,
matrix_free_step_flops, predict_request_flops: no factorization in a
request), over the window's length and 67 TFLOP/s."""

from portbench.readers import peak_percent


def read(run):
    return peak_percent(run)
