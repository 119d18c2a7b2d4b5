"""The benchmark's harness: cells and metrics found by name, the system
under test, the measured window, the traced phases, the bound arithmetic
and the comparison with the plain reference (`refsim`)."""
