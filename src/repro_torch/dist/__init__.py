"""The planning layer of the port, counterpart of `repro.dist`.

Submodules (import them directly; nothing heavy happens at import):
  sharding -- logical-axis -> mesh-axis resolution, rule sets, the
              ambient mesh and rules, `constrain`, DTensor placements
  policy   -- memory-aware serve-layout policy over the (weight layout x
              cache spec) product
  hardware -- the H100 model: rates, memory, link bandwidths, `Roofline`,
              the card's memory counters, the kernels' work formulas
  cost     -- the cost walk: flops by dtype and bytes of the aten
              operations one call of a step dispatches (meta or card)
"""
