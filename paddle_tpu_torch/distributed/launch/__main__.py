import sys

from .main import launch

if __name__ == "__main__":
    sys.exit(launch())
