"""Function packages: Presto-semantic (core) and Spark-semantic scalars."""
