"""Operation and byte counts, and the table of peaks: the yardstick of the
rooflines and of ``mfu``.  Plain arithmetic on shapes; imports nothing of
the program."""
