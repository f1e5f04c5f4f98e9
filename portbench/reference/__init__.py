"""The plain reference: numpy only, nothing of the program."""
