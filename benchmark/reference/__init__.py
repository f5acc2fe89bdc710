"""The plain reference of the benchmark's cells: plain PyTorch and numpy,
written from the algorithms' public definitions (OpenCV's
``detectMultiScale`` and ``groupRectangles``, TM_CCOEFF_NORMED, snapshot
and sklearn PCA, cosine matching).  It imports nothing of the program and
works out every model, table and operand again from the benchmark's
inputs.  Each function takes an :class:`~.numerics.Arith`: the reference
computes in float64, and the control, the same code one precision lower
than the configuration states, in :meth:`~.numerics.Arith.control`."""
