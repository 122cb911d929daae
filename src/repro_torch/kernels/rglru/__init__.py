"""RG-LRU scan of Griffin (recurrentgemma): the CUDA kernel and its plain version."""
