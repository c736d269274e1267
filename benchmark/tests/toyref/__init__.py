"""A toy reference for the harness's tests: a detector that differs from
`benchmark.reference` in structure, added as new modules only."""
