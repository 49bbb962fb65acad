"""The video swap's window core."""
