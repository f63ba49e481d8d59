"""Built-in problem model families (the reference's `examples/` as a library):

  * nqueens — N-Queens, SimpleScore (`examples/nqueens`)
  * tsp     — traveling salesman, HardSoftScore (`examples/tsp`)
  * vrp     — multi-depot CVRP(-TW), HardMediumSoftScore (`examples/vrp`)
  * mixedint — continuous / mixed-integer benchmark functions for LSHADE
"""
