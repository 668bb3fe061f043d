from repro_torch.kernels.fed_agg.ops import fed_agg, fed_agg_tree
