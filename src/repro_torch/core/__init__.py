"""DSBA/DSA, the operators, mixing matrices, the sparse relay and ``solve``."""
