"""Input generators: every input a cell hands the program is made here from ``--seed``."""
