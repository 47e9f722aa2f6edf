"""The yardstick's arithmetic: the card's published peaks, each hand
kernel's operations and bytes at a launch's shapes, and the launches of a
training step and of a served request at a configuration's shapes."""
