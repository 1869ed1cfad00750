"""Model pieces of the port: parameter specs, the causal conv and the
mLSTM block."""
