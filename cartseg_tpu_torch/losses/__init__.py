"""Losses: region BCE+Dice, label-smoothed CE and the Active Boundary Loss."""
