"""The benchmark's plain reference, in NumPy: frozen copies of the port's
row-vectorized integer NW fill, its traceback and scoring, and of the
abbreviation expansion of an OCR stream. It imports nothing of the
program and takes nothing the program made: the benchmark hands it the
same inputs it hands the program.
"""
