"""The code that the entries of one kind of configuration share: its
state on the card, its inputs and the parts of its comparison."""
