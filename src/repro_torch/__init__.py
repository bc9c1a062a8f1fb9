"""PyTorch/CUDA port of the DSBA reproduction (the JAX package ``repro``).

Module names mirror ``repro``'s so each counterpart is easy to find:
``data.{synthetic, sharded_loader}``, ``configs``, ``core.{mixing,
operators, reference, comm, dsba, sparse_comm, solvers}``, ``kernels``,
``models``, ``serve``, ``optim.adam``, ``train.step``, ``ckpt`` and
``launch.{serve, train}``; ``convert`` carries states, datasets and model
weights between the two packages. Importing the package has no side effects: no device is
probed and nothing is compiled until a kernel is first launched.

Entry points (``core.solvers.solve``, ``core.reference.solve_root``,
``convert``) run on CUDA unless the caller passes ``device="cpu"``;
without a card and without ``device`` they raise.
"""
