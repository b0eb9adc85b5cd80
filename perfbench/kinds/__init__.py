"""The kinds of job a traffic file can name (its ``kind``): each module
here has a ``Job`` that sets a cell up, runs its measured and traced
windows, and gives the program's readings and the reference's."""
