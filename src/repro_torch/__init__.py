"""PyTorch/CUDA port of the DSBA reproduction (the JAX package ``repro``).

Module names mirror ``repro``'s so each counterpart is easy to find:
``data.{synthetic, sharded_loader}``, ``configs``, ``core.{mixing,
operators, reference, comm, dsba, sparse_comm, solvers, gossip}``,
``kernels``, ``models``, ``serve``, ``optim.adam``, ``train.step``,
``ckpt``, ``ft.{elastic, faults}``, ``launch.{serve, train}`` and
``examples.train_lm_gossip``; ``convert`` carries states, datasets, model
weights and gossip states between the two packages. Importing the package has no side effects: no device is
probed and nothing is compiled until a kernel is first launched.

Entry points (``core.solvers.solve``, ``core.reference.solve_root``,
``core.gossip.init_gossip_state``, the launchers, the gossip example and
``convert``) run on CUDA unless the caller passes ``device="cpu"``;
without a card and without ``device`` they raise.
"""
