"""Small helpers the serving path needs: int8 narrowing and deadlines."""
