"""The benchmark's harness: name resolution (`plan`), the inputs drawn
from the seed (`draw`), the program's adapter (`port`), the run of a cell
(`cell`) and the reduction of its trace (`profile`)."""
