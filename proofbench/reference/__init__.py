"""The plain reference that decides `correct` (plain Python ints and numpy;
nothing of the program)."""
