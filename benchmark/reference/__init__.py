"""The benchmark's plain reference: the accessibility DP
(`raccess.LinearRaccess`, numpy float64), the page index (`index`) and
the search of one query against one target (`search`). Imports numpy
and nothing of the program."""
