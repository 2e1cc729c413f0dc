"""The yardstick's frozen arithmetic: FLOP counts from shapes, kernel bounds
and the card's published peaks. Later changes to the port cannot move it."""
