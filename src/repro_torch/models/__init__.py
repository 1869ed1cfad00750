"""Model pieces of the port: parameter specs, layers, the causal conv,
the RG-LRU, mLSTM and sLSTM blocks, the MoE layer, and the model
assembly (``transformer``)."""
