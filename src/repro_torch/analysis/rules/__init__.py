"""The built-in rule set.  Importing this package registers every rule
(mirroring how importing ``repro_torch.fed.strategies`` registers the
built-in strategies); third-party rules register the same way::

    from repro_torch.analysis import Rule, register

    @register
    class MyRule(Rule):
        id = "XYZ001"
        ...
"""
from repro_torch.analysis.rules import (determinism, jit_purity,  # noqa: F401
                                        ledger, registry_contract,
                                        tracer_noop, x64)
