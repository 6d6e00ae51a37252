from . import main

if __name__ == "__main__":  # importing the module (as the port's import check does) runs nothing
    main()
