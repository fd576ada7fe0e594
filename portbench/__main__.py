import sys

from .run import main, process_start

if __name__ == "__main__":
    t_process = process_start()
    sys.exit(main(t_process=t_process))
