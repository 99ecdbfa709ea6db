"""The paper's technique: profiling, Alg. 1, Eq. 4 and the tier split."""
